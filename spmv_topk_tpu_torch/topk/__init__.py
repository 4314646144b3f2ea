from .merge import finalize_topk, merge_candidates_host
