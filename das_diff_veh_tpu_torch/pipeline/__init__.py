"""Pipeline of the port: the per-chunk path, the batch workflows over date
folders (``workflow``) and their command line (``cli``)."""
