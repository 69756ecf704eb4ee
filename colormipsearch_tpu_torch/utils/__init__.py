from colormipsearch_tpu_torch.utils.metrics import Metrics, stage_timer

__all__ = ["Metrics", "stage_timer"]
