"""Multi-device layer: a (data, kernels) device mesh and sharded bank
convolution on ``torch.distributed`` — the port of
``cuda_fft_convolution_tpu/parallel``.

Where the reference peer-copies the data FFT to each GPU
(src/cudaConvFFTDataStreams.cu:282) and round-robins kernels over GPU ×
stream slots (:338-469), a ``DeviceMesh`` carries the same strategy: the
data spectra replicated along the kernel axis, the kernel bank sharded over
it, the batch over the data axis. One rank owns one device and the ranks
run SPMD; outputs are ``DTensor``s. ``dryrun`` runs the layer in a world of
spawned ranks (``python -m cuda_fft_convolution_torch.parallel.dryrun``).
"""

from cuda_fft_convolution_torch.parallel.mesh import (
    conv_spectral_sharded,
    detect_peaks_sharded,
    make_mesh,
    shard_kernel_bank,
    train_step_sharded,
)

__all__ = [
    "conv_spectral_sharded",
    "detect_peaks_sharded",
    "make_mesh",
    "shard_kernel_bank",
    "train_step_sharded",
]
