"""Model layer: the workloads the reference library serves.

The port of ``cuda_fft_convolution_tpu.models``: the detection heads
(``detect.py``), the HOG front end of the DPM detector path (``hog.py``),
multi-scale detection over an image pyramid (``pyramid.py``), MOSSE
correlation filters (``mosse.py``) and the trainable filter-bank detector
(``filter_bank.py``). Every name the JAX package's ``models`` exports is
exported here, with ``detector_from_numpy`` and ``mosse_from_numpy``,
which carry the JAX package's model parameters across.
"""

from cuda_fft_convolution_torch.models.detect import (
    detect_local_peaks,
    detect_peaks,
    detect_top_k,
)
from cuda_fft_convolution_torch.models.filter_bank import (
    FilterBankDetector,
    detect,
    detector_from_numpy,
    init_detector,
    loss_fn,
    train_step,
)
from cuda_fft_convolution_torch.models.hog import hog_features
from cuda_fft_convolution_torch.models.mosse import (
    MosseFilter,
    gaussian_target,
    mosse_from_numpy,
    respond,
    train_mosse,
    update_mosse,
)
from cuda_fft_convolution_torch.models.pyramid import (
    Pyramid,
    PyramidPeaks,
    build_pyramid,
    detect_pyramid,
    detect_pyramid_peaks,
    top_detections,
)

__all__ = [
    "detect_peaks",
    "detect_top_k",
    "detect_local_peaks",
    "hog_features",
    "FilterBankDetector",
    "detect",
    "detector_from_numpy",
    "init_detector",
    "loss_fn",
    "train_step",
    "MosseFilter",
    "gaussian_target",
    "mosse_from_numpy",
    "respond",
    "train_mosse",
    "update_mosse",
    "Pyramid",
    "PyramidPeaks",
    "build_pyramid",
    "detect_pyramid",
    "detect_pyramid_peaks",
    "top_detections",
]
