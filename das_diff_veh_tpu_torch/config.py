"""Typed configuration tree of the per-chunk path and the batch runtime.

A copy of the main-path dataclasses of ``das_diff_veh_tpu/config.py`` and of
its ``ObsConfig``, ``ServeConfig`` and ``MeshServeConfig``, field for field
and default for default (tests/test_torch_config.py compares the two through
``dataclasses.asdict``).
The port keeps its own copy because the JAX package's ``__init__`` imports
JAX.  Knobs the port does not implement
yet keep their field so a JAX configuration converts one to one
(``convert.config_from_dict``); the functions that would read them raise.
``AmbientConfig`` is the port's own: the ambient-noise day stack of
``pipeline.ambient`` has no counterpart in the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class InterrogatorConfig:
    """Channel geometry of one interrogator."""

    name: str = "odh3"
    start_ch: int = 400          # first physical channel of the fiber section
    dx: float = 8.16             # channel spacing [m]
    fs: float = 250.0            # sampling rate [Hz]


@dataclass(frozen=True)
class DetectConfig:
    """Peak detection knobs."""

    min_prominence: float = 0.2
    min_separation: int = 50          # samples between peaks
    prominence_wlen: int = 600        # window for prominence evaluation
    height: Optional[float] = None
    max_peaks: int = 64               # fixed output capacity


@dataclass(frozen=True)
class TrackingConfig:
    """Kalman-filter vehicle tracking."""

    detect: DetectConfig = field(default_factory=DetectConfig)
    n_detect_channels: int = 15       # channels stacked for initial detection
    likelihood_sigma: float = 0.08    # KDE sigma [s] for detection stacking
    sigma_a: float = 0.01             # process-noise scale
    channel_stride: int = 3           # march every `stride` channels
    gate_lo: float = -15.0            # association gate (samples), asymmetric
    gate_hi: float = 30.0
    meas_noise: float = 1.0           # R
    max_vehicles: int = 64            # fixed vehicle-slot capacity
    assoc_bug_compat: bool = True     # record the first gated peak (reference slip)


@dataclass(frozen=True)
class TrackQCConfig:
    """Track sanity rejection."""

    min_valid_fraction: float = 0.3
    retrograde_window: int = 20
    retrograde_threshold: float = -15.0
    min_travel_samples: float = 30.0
    max_adjacent_nan: int = 20
    max_jump: float = 20.0


@dataclass(frozen=True)
class TrackingPreprocessConfig:
    """Quasi-static band preprocessing for tracking."""

    flo: float = 0.08                 # temporal band [Hz]
    fhi: float = 1.0
    subsample: int = 5                # 250 Hz -> 50 Hz
    target_dx: float = 1.0            # spatial resample 8.16 m -> 1 m
    flo_space: float = 0.006          # spatial band [cycles/m]
    fhi_space: float = 0.04
    noise_level: float = 10.0         # channel kill threshold (median abs)
    empty_threshold: float = 30.0


@dataclass(frozen=True)
class SurfaceWavePreprocessConfig:
    """Surface-wave band preprocessing."""

    flo: float = 1.2                  # [Hz]
    fhi: float = 30.0
    noise_threshold: float = 5.0
    impute_noisy: bool = True
    impute_empty: bool = True
    normalize_traces: bool = True     # per-trace L2 norm (surface_wave method)


@dataclass(frozen=True)
class WindowConfig:
    """Per-vehicle surface-wave window geometry."""

    wlen_sw: float = 8.0              # window length [s]
    length_sw: float = 300.0          # window spatial extent [m]
    spatial_ratio: float = 0.75       # fraction of length_sw behind the pivot
    temporal_spacing: Optional[float] = None  # isolation spacing [s]; None -> wlen_sw


@dataclass(frozen=True)
class MuteConfig:
    """Trajectory-aware muting."""

    offset: float = 300.0             # taper width [m]
    alpha: float = 0.3                # tukey shape, single-sided mute
    alpha_double: float = 0.05        # tukey shape, double-sided mute
    delta_x: float = 20.0             # asymmetric center shift [m]
    time_alpha: float = 0.3


@dataclass(frozen=True)
class GatherConfig:
    """Virtual-shot-gather interferometry.

    ``traj_gather``: window-cut engine of the trajectory-following
    correlations (``ops.xcorr.xcorr_traj_follow``).  ``"auto"`` launches the
    CUDA gather kernel (``ops.traj_gather``) for a CUDA tensor and runs its
    plain version for a CPU tensor; ``"fused"`` does the same without the
    shape gate; ``"serialized"`` cuts each channel with its own slice.
    ``traj_gather_finish="dot"`` correlates in the gather kernel
    (``csrc/traj_dot.cu``) for ``wlen <= dot_max_wlen`` and
    ``nwin*wlen^2 <= dot_max_matrix_elems``; ``precision`` is its tier.
    """

    wlen: float = 2.0                 # correlation window [s]
    time_window: float = 4.0          # data span fed to xcorr [s]
    delta_t: float = 1.0              # pivot-time offset [s]
    overlap_ratio: float = 0.5
    norm: bool = True                 # per-trace L2 norm of the gather
    norm_amp: bool = True             # normalize by pivot-trace max
    include_other_side: bool = True
    far_offset: float = 75.0          # gather far end beyond the pivot [m]
    traj_gather: str = "auto"
    traj_gather_finish: str = "rfft"
    fused_max_nwin: int = 64
    dot_max_wlen: int = 256
    dot_max_matrix_elems: int = 1 << 20
    precision: str = "f32"


@dataclass(frozen=True)
class DispersionConfig:
    """f-v transform scan grid."""

    freq_min: float = 0.8
    freq_max: float = 25.0
    freq_step: float = 0.1
    vel_min: float = 200.0
    vel_max: float = 1200.0
    vel_step: float = 1.0
    sg_window: int = 25               # savgol smoothing along frequency
    sg_order: int = 4
    norm: bool = False                # L1 trace norm before transform
    method: str = "fk"                # or "phase_shift"
    precision: str = "f32"            # or "bf16"

    def freqs(self) -> np.ndarray:
        """Scan frequencies, built on the host (a float ``torch.arange`` can
        differ in length from numpy's)."""
        return np.arange(self.freq_min, self.freq_max, self.freq_step)

    def vels(self) -> np.ndarray:
        return np.arange(self.vel_min, self.vel_max, self.vel_step)

    @property
    def n_freqs(self) -> int:
        return int(self.freqs().size)

    @property
    def n_vels(self) -> int:
        return int(self.vels().size)


@dataclass(frozen=True)
class ImagingConfig:
    """One pivot's imaging geometry."""

    x0: float = 700.0                 # pivot along fiber [m]
    tracking_offset: float = 200.0    # start_x = x0 - offset, end_x = x0 + offset
    disp_start_x: float = -150.0      # offsets fed to the dispersion transform
    disp_end_x: float = 0.0

    @property
    def start_x(self) -> float:
        return self.x0 - self.tracking_offset

    @property
    def end_x(self) -> float:
        return self.x0 + self.tracking_offset


@dataclass(frozen=True)
class HealthConfig:
    """Input-health sentinel knobs (``resilience.health``).

    Masking an unhealthy channel changes output values, so ``health`` lives
    in :class:`PipelineConfig` and takes part in the resume manifest's
    config hash.  With ``enabled`` every chunk is screened once on its
    device before the pipeline sees it: non-finite samples are zeroed,
    channels with non-finite samples, a peak-to-peak span <=
    ``flatline_var`` or (with ``clip_limit`` > 0) a clipped fraction >=
    ``clip_fraction_max`` are masked (neighbor-imputed when ``impute``), and
    a chunk with more than ``max_masked_fraction`` of its channels masked is
    refused (``PoisonedChunkError``; the batch runtime quarantines it).
    ``nan_fraction_max`` bounds the non-finite fraction at admission
    (``resilience.health.admission_verdict``).  Disabled by default: the
    sentinel then costs one attribute check and no device work."""

    enabled: bool = False
    flatline_var: float = 0.0
    clip_limit: float = 0.0
    clip_fraction_max: float = 0.05
    impute: bool = True
    max_masked_fraction: float = 0.5
    nan_fraction_max: float = 0.0


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs of the batch runtime (``RuntimeConfig.obs``).

    Pure execution knobs: none of them changes an output bit, and the
    resume manifest's config hash excludes them.
    """

    enabled: bool = True
    """Master switch for the batch runtime's instrumentation (registry
    families, flight ring, sink, memory gauges).  False turns all of it
    off."""

    metrics_jsonl: Optional[str] = None
    """Append periodic registry snapshots (one JSON line each) here during
    batch runs.  None disables the sink."""

    metrics_interval_s: float = 10.0
    """Seconds between JSONL sink snapshots (a final line is always written
    when the run ends)."""

    flight_dir: Optional[str] = None
    """Directory for flight-recorder dumps: the last ``flight_capacity``
    per-chunk records as a JSON artifact on quarantine and SIGTERM
    (``scripts/obs_report.py`` renders them).  None keeps the in-memory
    ring but never writes."""

    flight_capacity: int = 256
    """Records retained in the flight-recorder ring."""

    profile_dir: Optional[str] = None
    """Write a ``torch.profiler`` Chrome trace of ``profile_n_chunks``
    steady-state chunks here (batch runs; the window opens after
    ``profile_start_chunk`` chunks so capture/warm-up noise stays out;
    ``obs.ProfilerWindow``)."""

    profile_start_chunk: int = 3
    """Chunks to skip before the profiler window opens (warmup exclusion)."""

    profile_n_chunks: int = 2
    """Chunks captured inside the profiler window."""

    hbm_sample_interval_s: float = 0.0
    """Background per-card ``torch.cuda.memory_stats()`` sampling period
    [s] (``obs.HBMSampler``).  0 registers the lazy scrape-time gauges only
    — no thread."""

    trace_flush_interval_s: float = 0.0
    """Chrome-trace writer flush cadence.  0 (default) flushes every event
    line — crash-durable, one syscall per span.  > 0 batches writes and
    flushes at most every this many seconds."""

    xla_events: bool = True
    """Subscribe the run's registry to the port's build events
    (``obs.build_events``: CUDA graph captures, fused programs, device
    constants and kernel libraries built), the counterpart of the JAX
    package's ``jax.monitoring`` compile counters and the truth source of
    the serving engine's ``das_serve_steady_state_compiles`` gauge.  The
    knob keeps the JAX name and changes no output bit."""


@dataclass(frozen=True)
class ServeConfig:
    """Online serving engine knobs (``das_diff_veh_tpu_torch.serve``), field
    for field those of the JAX package's ``ServeConfig``.

    Execution knobs, not physics: none of them changes a bit of an admitted
    request's result.  ``buckets`` decides how much zero padding a request's
    ``(n_ch, nt)`` gets before it reaches its bucket's program.
    """

    buckets: Tuple[Tuple[int, int], ...] = ()
    """Allowed padded request shapes, ``(n_ch, nt)`` each.  A request is
    padded up to the smallest bucket (by area) that fits it; a request no
    bucket fits is rejected at submit."""

    max_batch: int = 4
    """Same-bucket requests a dispatcher runs per batch, at most."""

    max_queue: int = 64
    """Admission-queue bound: ``submit`` raises ``QueueFullError`` past it."""

    batch_window_ms: float = 2.0
    """Deprecated and ignored, as in the JAX package: batching is
    continuous.  A non-default value warns (``DeprecationWarning``)."""

    default_deadline_ms: float = 30000.0
    """Deadline of a request that passes none; a request still queued past
    it is shed (``DeadlineExceededError``)."""

    warmup: bool = True
    """Build every bucket's program at ``start()`` (on the card: capture the
    fused chunk's graph, fill the constants cache, build the kernels), so
    steady-state requests build nothing."""

    latency_window: int = 1024
    """Completed-request latencies kept for the p50/p95/p99 snapshot."""

    compilation_cache_dir: Optional[str] = None
    """XLA's persistent compilation cache in the JAX package.  It has no
    meaning for PyTorch: an engine refuses a set value
    (``NotImplementedError``); the kernels build into ``build/kernels/``."""

    obs: ObsConfig = field(default_factory=ObsConfig)
    """Flight-recorder dumps on shed/error paths and the build-event
    counters behind ``das_serve_steady_state_compiles``;
    ``hbm_sample_interval_s > 0`` samples the card's memory from engine start
    to close."""

    health: Optional[HealthConfig] = None
    """Admission-time input-health screen: with it set and enabled,
    ``submit`` screens the request on the host (numpy, no device work) and
    sheds a poison one as ``PoisonInputError`` (HTTP 422).  None: no
    screen."""

    def __post_init__(self) -> None:
        if self.batch_window_ms != 2.0:
            import warnings
            warnings.warn(
                "ServeConfig.batch_window_ms is deprecated and ignored: "
                "the dispatcher batches continuously (iteration-level) "
                "instead of lingering for companions.  Drop the argument.",
                DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class MeshServeConfig:
    """Multi-tenant serving over the slots of a mesh (``serve.mesh``),
    field for field the JAX package's ``MeshServeConfig``: replica workers
    for independent requests, the all-pairs ring for large ones, tenant
    quotas and fair share.  Execution knobs: a request computes the same
    bits wherever it is placed."""

    serve: ServeConfig = field(default_factory=ServeConfig)
    """The wrapped engine config; ``serve.max_queue`` bounds the requests
    queued over every replica and the ring."""

    replicas: Optional[int] = None
    """Replica workers, one a slot of ``parallel.mesh.make_mesh(replicas,
    device=...)``.  None = one a card (one CPU slot with ``device="cpu"``)."""

    ring_min_channels: Optional[int] = None
    """Requests with at least this many valid channels take the ring
    placement.  None disables the ring route."""

    ring_devices: Optional[int] = None
    """Slots of the ring placements' mesh (``make_mesh``); None = every
    card."""

    tenant_quota: int = 32
    """Queued + in-flight requests one tenant may hold; the next submit
    sheds with ``TenantQuotaError`` (HTTP 429)."""

    tenant_poison_quarantine: Optional[int] = 3
    """Consecutive poison sheds after which a tenant is quarantined (None:
    never)."""

    drain_timeout_s: float = 30.0
    """How long ``drain_tenant`` / ``drain_replica`` wait for in-flight
    requests."""


@dataclass(frozen=True)
class BootstrapConfig:
    """Bootstrap uncertainty of the dispersion ridges (``analysis.bootstrap``;
    the reference's apis/imaging_classes.py:8-48)."""

    bt_times: int = 30
    bt_size: int = 60
    sigma: Tuple[float, ...] = (25.0, 50.0, 50.0, 50.0)
    ref_freq_idx: Tuple[int, ...] = (80, 130, 170, 170)
    freq_lb: Tuple[float, ...] = (2.5, 10.0, 14.0, 16.0)
    freq_ub: Tuple[float, ...] = (14.0, 15.0, 19.0, 20.0)
    vel_max: float = 800.0


@dataclass(frozen=True)
class FleetInversionConfig:
    """How ``inversion.fleet.invert_fleet`` cuts its (targets x runs x pop)
    working set.  Execution knobs, not physics."""

    target_chunk: int = 0
    """Targets inverted per call (0 = the whole fleet); each chunk is padded
    to this size by repeating a real target, and with a mesh rounded up to a
    multiple of its slots."""

    eval_chunk: int = 0
    """Population members whose misfits evaluate together (0 = all)."""

    refine_chunk: int = 0
    """Refinement starts per batch of the Adam stage (0 = all)."""


@dataclass(frozen=True)
class RingConfig:
    """Knobs of the all-pairs ring over a device mesh (``parallel.allpairs``).

    Execution knobs, not physics: on the kernel path every mode and
    buffering choice gives the same peaks bit for bit.  They trade the
    receiver spectra a slot holds against copies between slots."""

    mode: str = "ring"
    """``"ring"``: each slot holds its own nch/D receiver shard and the
    shards rotate one slot a step (``distributed.ring_perm``);
    ``"replicated"``: every slot holds the whole receiver set and nothing
    moves in the loop."""

    double_buffer: bool = True
    """Issue step k+1's shard copies before step k's correlation, so they
    overlap it; False copies only after the step's correlation has
    finished (to see the copy time on its own in a profile)."""

    lagmax_block: Optional[int] = None
    """Receiver rows per irfft + lag-peak slab of the peak finish
    (``ops.all_pairs.peak_from_spectra``): None = fused on the kernel path
    with the default block, 0 = unfused, > 0 = that block."""

    win_block: Optional[int] = None
    """Windows per slab of the cross-spectra (None = the automatic choice,
    > 0 = that slab); a per-call ``win_block`` wins over it."""

    lag_tile_max: int = 512
    """The JAX package's lag-tile cap of its TPU lag-max kernel; kept so a
    JAX configuration converts one to one, read by nothing here."""

    precision: str = "f32"
    """Tier of the ring's correlation: ``"f32"`` or ``"bf16"`` (bfloat16
    spectra, float32 sums)."""


@dataclass(frozen=True)
class AmbientConfig:
    """The ambient-noise day stack (``pipeline.ambient``): Bensen et al.
    (2007)'s one-bit normalisation, spectral whitening, windowed
    cross-correlation and linear stack, kept for every channel pair within
    ``max_offset`` channels and for the lags within ``max_lag`` samples of
    zero.  The port's own: the JAX package computes no such product.  The
    defaults are the PoroTomo DASH day stack (1 m channels at 1000 Hz)."""

    fs: float = 1000.0
    """Sampling rate of the records [Hz]."""

    wlen: int = 4096
    """Samples a correlation window."""

    overlap_ratio: float = 0.5
    """Overlap of consecutive windows (0.5: a window every ``wlen // 2``)."""

    band_hz: Tuple[float, float] = (2.0, 50.0)
    """Whitening band: the bins from ``ceil(lo * wlen / fs)`` to
    ``floor(hi * wlen / fs)`` keep their phase at unit amplitude, every
    other bin is zeroed."""

    one_bit: bool = True
    """Replace each sample by its sign before the windows are cut."""

    whiten: bool = True
    """Whiten the window spectra over ``band_hz``; False keeps them whole."""

    max_offset: int = 300
    """Receivers kept on each side of a source, in channels."""

    max_lag: int = 1000
    """Lags kept on each side of zero lag, in samples."""

    src_chunk: int = 64
    """Source rows a cross-spectra launch; each is correlated against the
    ``src_chunk + 2 * max_offset`` receiver rows around it."""

    def replace(self, **kw) -> "AmbientConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PipelineConfig:
    """Everything the per-chunk path reads, bundled."""

    interrogator: InterrogatorConfig = field(default_factory=InterrogatorConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    track_qc: TrackQCConfig = field(default_factory=TrackQCConfig)
    tracking_preprocess: TrackingPreprocessConfig = field(default_factory=TrackingPreprocessConfig)
    sw_preprocess: SurfaceWavePreprocessConfig = field(default_factory=SurfaceWavePreprocessConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    mute: MuteConfig = field(default_factory=MuteConfig)
    gather: GatherConfig = field(default_factory=GatherConfig)
    dispersion: DispersionConfig = field(default_factory=DispersionConfig)
    imaging: ImagingConfig = field(default_factory=ImagingConfig)
    bootstrap: BootstrapConfig = field(default_factory=BootstrapConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    fleet: FleetInversionConfig = field(default_factory=FleetInversionConfig)
    max_windows: int = 64             # per-chunk window capacity
    chunk_pipeline: str = "staged"    # or "fused": one CUDA graph per geometry

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> PipelineConfig:
    return PipelineConfig()
