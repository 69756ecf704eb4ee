"""PyTorch/CUDA port of the color depth MIP search engine.

The pixel-match pass (``colorDepthSearch``) runs on one NVIDIA GPU
through four hand-written CUDA kernels (``kernels/csrc``); the host
side (plan construction, interval tables, model entities, JSON writers) is
carried over from the JAX package so both produce identical results:

    import torch
    from colormipsearch_tpu_torch.engine.cds import CDSParams, CDSearchEngine

    engine = CDSearchEngine(CDSParams(mask_threshold=20, ...),
                            device=torch.device("cuda"))
    matches = engine.find_all_matches(mask_neurons, target_neurons)

The package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
