from colormipsearch_tpu_torch.results.grouping import (
    group_by_mask,
    group_by_target,
    sort_matches_desc,
)

__all__ = ["group_by_mask", "group_by_target", "sort_matches_desc"]
