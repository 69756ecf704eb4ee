from colormipsearch_tpu_torch.engine.cds import CDSParams, CDSearchEngine

__all__ = ["CDSParams", "CDSearchEngine"]
