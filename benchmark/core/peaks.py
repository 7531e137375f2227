"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheets, dense rates, at the full power limit)."""

#: NVIDIA H100 SXM 80 GB: HBM3 bandwidth, bytes per second.
HBM_BYTES_PER_S = {"H100": 3.35e12}


def hbm_bytes_per_s(device_name: str) -> float:
    for key, value in HBM_BYTES_PER_S.items():
        if key in device_name:
            return value
    raise KeyError(f"no peak bandwidth known for {device_name!r}")
