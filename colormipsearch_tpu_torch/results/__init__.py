from colormipsearch_tpu_torch.results.grouping import (
    group_by_mask,
    group_by_target,
    select_best_matches,
    select_top_ranked,
    sort_matches_desc,
)

__all__ = ["group_by_mask", "group_by_target", "select_best_matches",
           "select_top_ranked", "sort_matches_desc"]
