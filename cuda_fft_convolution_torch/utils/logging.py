"""Debug logging, as the JAX package's ``utils/logging.py``: a standard
logger in place of the reference's compile-time ``static bool debug``
flags gating ``fprintf(stderr)`` prints (src/cudaConvolutionFFT.cu:9,60,100).
``FFTCONV_DEBUG=1`` turns on debug output when the module is imported.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("cuda_fft_convolution_torch")

if os.environ.get("FFTCONV_DEBUG", "0") not in ("0", "", "false", "False"):
    logging.basicConfig(level=logging.DEBUG)
    logger.setLevel(logging.DEBUG)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args)
