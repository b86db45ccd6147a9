"""apda_fft_tpu_torch - the spectral pipeline of ``apda_fft_tpu`` on PyTorch and CUDA.

A port of the JAX package beside it, module for module and name for name.
It imports torch and numpy only.  The flexible-mode detector's fused
select+scan stage, the fused FFT front end (``backend="pallas"``), the
pre-selected prominence scans (:func:`prominence_peaks_batch`) and the whole
single-window latency pipeline (:func:`analyze_window_lowlat`, flexible and
rigid) run as hand-written CUDA kernels for Hopper (``sm_90a``) on CUDA
tensors and as plain torch on CPU tensors.  An epoch runs on the card: a
tensor's on its own device, an array or list on CUDA unless ``device="cpu"``
is given (without a CUDA device an array raises ``RuntimeError``).  Ragged
records (:func:`analyze_records`), streams
(:func:`analyze_stream`, :func:`analyze_epochs_pipelined`), Welch averaging
and cross spectra run on the same kernels, and so does the modal analysis
(:func:`fdd`, whose detector is the select+scan kernel; :func:`ssi`).  The
field ops (integration, ring-down damping, resampling, the shock response
spectrum) are torch and host numpy.  The gateway (``gateway/``, ``io/``,
:class:`PeakTracker`) is host code whose analysis legs run on the card.

Quick start::

    import apda_fft_tpu_torch as apda
    result = apda.analyze_epoch(samples, fs=500.0, mode="flexible", refine=True)
    result.freq, result.mag, result.count
"""

from apda_fft_tpu_torch.models.batching import RecordPeaks, analyze_records
from apda_fft_tpu_torch.models.modal import (
    FDDResult,
    ModalTracker,
    ModeTrack,
    csd_matrix,
    fdd,
    modal_assurance,
)
from apda_fft_tpu_torch.models.pipeline import (
    PipelineConfig,
    SpectralPipeline,
    analyze_epoch,
    default_k,
    detect_from_mags,
    dynamic_state,
    last_dynamic_stats,
    load_dynamic_state,
    reset_dynamic_state,
    steady_state_max_candidates,
)
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.models.ssi import (
    SSIMode,
    SSIResult,
    correlation_blocks,
    modal_phase_collinearity,
    ssi,
)
from apda_fft_tpu_torch.models.streaming import (
    analyze_epochs_pipelined,
    analyze_stream,
    analyze_welch,
    coherence,
    coherence_with_phase,
    cross_psd,
    frame_records,
    spectrogram,
    welch_psd,
)
from apda_fft_tpu_torch.models.tracking import PeakTracker, Track, match_peaks
from apda_fft_tpu_torch.ops.detector_cuda import (
    prominence_peaks_batch,
    prominence_peaks_fused,
    prominence_select_scan,
)
from apda_fft_tpu_torch.ops.latency_cuda import analyze_window_lowlat
from apda_fft_tpu_torch.ops.fft import (
    center_and_pad,
    full_spectrum,
    halfspec_magnitudes,
    next_pow2,
    taper_window,
)
from apda_fft_tpu_torch.ops.integrate import (
    G_TO_MMS2,
    displacement,
    integrate_acceleration,
    velocity,
    velocity_rms,
)
from apda_fft_tpu_torch.ops.peaks_prominence import ProminencePeaks, prominence_peaks
from apda_fft_tpu_torch.ops.peaks_resolution import ResolutionPeaks, resolution_peaks
from apda_fft_tpu_torch.ops.resample import (
    decimate,
    decimation_factor,
    rational_factors,
    resample_rational,
)
from apda_fft_tpu_torch.ops.ringdown import ringdown_damping
from apda_fft_tpu_torch.ops.srs import (
    SRSResult,
    shock_response_spectrum,
    smallwood_coefficients,
    srs_frequencies,
)
from apda_fft_tpu_torch.utils.profiling import EpochMetrics

__version__ = "0.1.0"

__all__ = [
    "EpochMetrics",
    "EpochResult",
    "FDDResult",
    "G_TO_MMS2",
    "ModalTracker",
    "ModeTrack",
    "PeakTracker",
    "PipelineConfig",
    "ProminencePeaks",
    "RecordPeaks",
    "ResolutionPeaks",
    "SRSResult",
    "SSIMode",
    "SSIResult",
    "SpectralPipeline",
    "Track",
    "analyze_epoch",
    "analyze_epochs_pipelined",
    "analyze_records",
    "analyze_stream",
    "analyze_welch",
    "analyze_window_lowlat",
    "center_and_pad",
    "coherence",
    "coherence_with_phase",
    "correlation_blocks",
    "cross_psd",
    "csd_matrix",
    "decimate",
    "decimation_factor",
    "default_k",
    "detect_from_mags",
    "displacement",
    "dynamic_state",
    "fdd",
    "frame_records",
    "full_spectrum",
    "halfspec_magnitudes",
    "integrate_acceleration",
    "last_dynamic_stats",
    "load_dynamic_state",
    "match_peaks",
    "modal_assurance",
    "modal_phase_collinearity",
    "next_pow2",
    "prominence_peaks",
    "prominence_peaks_batch",
    "prominence_peaks_fused",
    "prominence_select_scan",
    "rational_factors",
    "resample_rational",
    "reset_dynamic_state",
    "resolution_peaks",
    "ringdown_damping",
    "shock_response_spectrum",
    "smallwood_coefficients",
    "spectrogram",
    "srs_frequencies",
    "ssi",
    "steady_state_max_candidates",
    "taper_window",
    "velocity",
    "velocity_rms",
    "welch_psd",
]
