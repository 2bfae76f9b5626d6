"""Frozen plain reference of the vehicle-imaging chain.

A copy of the PyTorch port's plain (CPU) path, frozen at the commit that
added the benchmark, so that later changes to the program cannot move the
yardstick.  Copied from ``das_diff_veh_tpu_torch``: ``config.py``,
``core/section.py``, ``core/constants.py``, ``models/{tracking,windows,vsg}.py``,
``ops/{xcorr,dispersion,filters,qc,resample,peaks,savgol,interp,precision}.py``,
``resilience/health.py`` and ``pipeline/preprocess.py``; :mod:`.chain` follows
``io/readers.py`` and ``pipeline/timelapse.py``.  Departures from the copied
files: imports made relative; the trajectory-following correlation always takes
the serialized cut (one gather per channel pair, correlated by rfft), never the
gather kernels B1/B2 or their plain versions; the constants cache keeps no
build counter; the f-v enhancement is left out.  It imports nothing of the
program and no JAX.  It runs in float64 on whatever device it is given.
"""
