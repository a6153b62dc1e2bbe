"""Bytes that the exact self-KNN of each encoder level (the KNN kernel B1)
has to move for one cloud: each point read once (3 float32), and for each
point its K indices (int32) and squared distances (float32) written once."""

from portbench.counts.model_flops import level_sizes


def forward(cfg: dict, n: int) -> float:
    k = cfg["n_neighbors"]
    return float(sum(rows * (3 * 4 + k * (4 + 4)) for rows in level_sizes(cfg, n)[:-1]))
