from saccot.match.topk import match_descriptors, mutual_filter  # noqa: F401
