"""Device layer of the IVF path: distances, quantization, top-k, the IVF
index and its CUDA probe-scan kernels."""
