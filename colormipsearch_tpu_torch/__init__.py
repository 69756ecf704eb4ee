"""PyTorch/CUDA port of the color depth MIP search engine.

The pixel-match pass (``colorDepthSearch``) and the shape pass
(``gradientScores``) run on one NVIDIA GPU through hand-written CUDA
kernels (``kernels/csrc``); the host side (plan construction, interval
tables, model entities, JSON writers) is carried over from the JAX
package so both produce identical results. Library surface (the CLI in
``cli/`` wraps these):

    from colormipsearch_tpu_torch import CDSParams, color_depth_search

    matches = color_depth_search(mask_neurons, target_neurons,
                                 CDSParams(mask_threshold=20, ...),
                                 device="cuda")

``device`` is explicit: "cuda" runs the kernels (an error without a
GPU), "cpu" their plain PyTorch versions. The package imports ``torch``
and never ``jax``.
"""

__version__ = "0.1.0"

from colormipsearch_tpu_torch.engine.cds import CDSParams


def color_depth_search(masks, targets, params=None, *, neg_query=None,
                       neg_query_threshold=None, mirror_neg_query=False,
                       device="cuda", **kwargs):
    """All-pairs pixel-match search; returns CDMatch entities.

    Args:
      masks/targets: Neuron entities (see model/) or image file paths
        (directories, zip archives or files).
      params: CDSParams (defaults to production-like values).
      neg_query: optional negative-query image (path or uint8 RGB array)
        whose matches are subtracted from every mask's score
        (PixelMatchColorDepthSearchAlgorithm.java:195-217).
      neg_query_threshold / mirror_neg_query: negative-query variant of
        the mask threshold / mirror flags.
      device: "cuda" or "cpu" (or a torch.device).
      kwargs: forwarded to CDSearchEngine.find_all_matches.
    """
    from colormipsearch_tpu_torch.engine.cds import CDSearchEngine
    from colormipsearch_tpu_torch.io import mips as mips_io
    from colormipsearch_tpu_torch.model import Neuron

    def to_neurons(items):
        paths = [i for i in items if not isinstance(i, Neuron)]
        out = [i for i in items if isinstance(i, Neuron)]
        if paths:
            fds = []
            for p in paths:
                fds.extend(mips_io.list_image_files(str(p)))
            out.extend(mips_io.neurons_from_image_files(fds))
        return out

    neg_rgb = None
    if neg_query is not None:
        import numpy as np

        if isinstance(neg_query, np.ndarray):
            neg_rgb = neg_query
        else:
            from colormipsearch_tpu_torch.io.image import read_image

            neg_rgb = read_image(str(neg_query)).as_rgb()

    engine = CDSearchEngine(params or CDSParams(), device=device,
                            neg_query_rgb=neg_rgb,
                            neg_query_threshold=neg_query_threshold,
                            mirror_neg_query=mirror_neg_query)
    return engine.find_all_matches(to_neurons(masks), to_neurons(targets),
                                   **kwargs)


def gradient_scores(matches, params=None, *, device="cuda", **kwargs):
    """Shape (gradient-area-gap) rescoring of existing matches."""
    from colormipsearch_tpu_torch.engine.gradscore import GradScoreEngine

    engine = GradScoreEngine(params or CDSParams(), device=device)
    return engine.score_matches(matches, **kwargs)


__all__ = ["CDSParams", "color_depth_search", "gradient_scores",
           "__version__"]
