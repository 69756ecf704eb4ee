"""Hand-written CUDA kernels of the pixel-match pass (``csrc/``), their
build (:mod:`.build`) and launch counters."""
