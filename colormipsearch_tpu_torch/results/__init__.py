from colormipsearch_tpu_torch.results.grouping import (
    ScoredEntry,
    group_by_mask,
    group_by_target,
    partition_collection,
    select_best_matches,
    select_top_ranked,
    sort_matches_desc,
)

__all__ = ["ScoredEntry", "group_by_mask", "group_by_target",
           "partition_collection", "select_best_matches",
           "select_top_ranked", "sort_matches_desc"]
