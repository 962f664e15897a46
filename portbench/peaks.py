"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheets,
at the full power limit)."""

# Device memory bytes per second, by ``torch.cuda.get_device_name()``.
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
}


def hbm_bytes_per_s(kind: str) -> float | None:
    return HBM_BYTES_PER_S.get(kind)
