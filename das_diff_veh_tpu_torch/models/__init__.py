"""Tracking, window selection and virtual shot gathers."""
