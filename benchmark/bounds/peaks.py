"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W power limit). Every share of a peak in the benchmark is
stated against these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # tensor cores, dense


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time a launch can take: its bytes over the memory's
    bandwidth or its f32 operations over the f32 peak, the larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
