"""Model layer: the workloads the reference library serves.

So far the detection heads (``models/detect.py``, the port of
``cuda_fft_convolution_tpu.models.detect``) and the HOG front end of the
DPM detector path (``models/hog.py``). The pyramid, MOSSE and filter-bank
models are still to port (ROADMAP queue 1 item 9).
"""

from cuda_fft_convolution_torch.models.detect import (
    detect_local_peaks,
    detect_peaks,
    detect_top_k,
)
from cuda_fft_convolution_torch.models.hog import hog_features

__all__ = ["detect_peaks", "detect_top_k", "detect_local_peaks", "hog_features"]
