"""How the port's redesigned kernels pick their design, on the CPU.

``flash_attention`` has two routes ("mma": bf16 on the tensor cores,
"simt": fp32 FMAs on the CUDA cores) and ``node_mlp`` three variants
("narrow", "shallow", "tiled"); each is a pure function of dtype and
shapes, chosen before the launch, and a design that cannot take its
inputs raises instead of falling back.  The checks here need no card:
the choice, the refusals, the mma route's alignment rule (on CPU
tensors: it reads only pointers and strides) and Python mirrors of the
shared-memory budgets the CUDA sources launch with.  The kernels
themselves are held against their plain versions on the card
(``tests/test_torch_on_card.py``, ``chip_smoke.py``).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_mp as FM
from repro_torch.kernels import node_mlp as NM
from repro_torch.kernels import ops as kops

# ------------------------------------------------------------ flash_attention


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_route_is_mma_for_bf16_at_tensor_core_head_dims(d):
    assert FA.route(torch.bfloat16, d) == "mma"
    FA.check_route("mma", torch.bfloat16, d)
    FA.check_route("simt", torch.bfloat16, d)  # forcing the other design is allowed


@pytest.mark.parametrize("dtype,d", [(torch.float32, d) for d in FA.HEAD_DIMS]
                         + [(torch.bfloat16, d) for d in (8, 16, 32)])
def test_flash_route_is_simt_elsewhere_and_mma_refused(dtype, d):
    assert FA.route(dtype, d) == "simt"
    FA.check_route("simt", dtype, d)
    with pytest.raises(ValueError, match="no instance"):
        FA.check_route("mma", dtype, d)


def test_flash_unknown_route_refused():
    with pytest.raises(ValueError, match="unknown route"):
        FA.check_route("wgmma", torch.bfloat16, 128)


# one SM's shared memory: 228 KB, of which each resident block reserves 1 KB
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1_024


@pytest.mark.parametrize("d, capped, want", [
    (64, False, 57_344), (128, False, 114_688), (256, False, 98_304),
    (64, True, 57_344), (128, True, 114_688), (256, True, 65_536)])
def test_flash_mma_shared_memory_fits(d, capped, want):
    """Q tile plus the K / V ring (three stages at D <= 128, two at 256),
    bf16: one block's limit holds it, and two CTAs fit one SM."""
    got = FA.mma_smem_bytes(d, capped)
    stages = 3 if d < 256 else 2
    assert got == (FA.MMA_BLOCK_Q + 2 * stages * FA.mma_block_k(d, capped)) * d * 2 == want
    assert got <= FM.MAX_SMEM_BYTES
    assert 2 * (got + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


@pytest.mark.parametrize("capped", (False, True))
def test_flash_mma_shared_memory_fits_the_mla_pair(capped):
    """(D, Dv) = (96, 64): Q and K rows padded to 104 elements (96 is no
    multiple of the 64-column swizzle), V's 64 swizzled; three stages of
    64 keys: (64 x 104 + 3 x 64 x (104 + 64)) x 2 bytes, two CTAs an SM."""
    got = FA.mma_smem_bytes(96, capped, dv=64)
    assert FA.mma_pitch(96) == 104 and FA.mma_pitch(64) == 64
    assert got == (64 * 104 + 3 * 64 * (104 + 64)) * 2 == 77_824
    assert 2 * (got + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES


@pytest.mark.parametrize("dtype, want", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_flash_route_of_the_mla_pair(dtype, want):
    assert FA.route(dtype, 96, 64) == want
    FA.check_route("simt", dtype, 96, 64)
    if want == "mma":
        FA.check_route("mma", dtype, 96, 64)
    else:
        with pytest.raises(ValueError, match="no instance"):
            FA.check_route("mma", dtype, 96, 64)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("layout", ["bhsd", "bshd_view", "one_row", "one_batch"])
def test_flash_mma_layout_accepts_the_serving_views(layout):
    b, h, s, d = 2, 4, 24, 128
    if layout == "bhsd":
        t = _bf16(b, h, s, d)
    elif layout == "bshd_view":  # (B, S, H, D) tensors transposed, as gqa_apply passes
        t = _bf16(b, s, h, d).transpose(1, 2)
    elif layout == "one_row":  # S = 1: the row stride is never used
        t = torch.as_strided(_bf16(b * h * d), (b, h, 1, d), (h * d, d, 3, 1))
    else:  # B = 1 with an odd batch stride
        t = torch.as_strided(_bf16(h * s * d + 8), (1, h, s, d), (3, s * d, d, 1))
    FA.check_mma_layout(t)


@pytest.mark.parametrize("bad", ["offset", "row_stride", "head_stride"])
def test_flash_mma_layout_refuses_misaligned_views(bad):
    b, h, s, d = 1, 4, 16, 64
    if bad == "offset":  # data 2 bytes past a 16-byte boundary
        t = _bf16(b * h * s * d + 1)[1:].view(b, h, s, d)
    elif bad == "row_stride":  # rows 68 elements apart
        t = _bf16(b, h, s, d + 4)[..., :d]
    else:
        t = torch.as_strided(_bf16(b * h * (s * d + 4)), (b, h, s, d),
                             (h * (s * d + 4), s * d + 4, d, 1))
    assert t.data_ptr() % 16 == 0 or bad == "offset"
    with pytest.raises(ValueError, match="16-byte"):
        FA.check_mma_layout(t)


def test_flash_cpu_dispatch_counts_no_route():
    q = torch.randn(1, 2, 8, 64).bfloat16()
    before = (FA.launches, dict(FA.launches_by_route))
    out = kops.flash_attention(q, q, q)
    assert out.shape == q.shape
    assert (FA.launches, FA.launches_by_route) == before
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, q, q, force_route="simt")
    assert (FA.launches, FA.launches_by_route) == before


# ------------------------------------------------------------------ node_mlp


@pytest.mark.parametrize("m, k, n, want", [
    (128, 100, 1, "narrow"),     # GIN's head
    (4096, 100, 200, "tiled"),   # GIN's MLP, first layer
    (4096, 200, 100, "tiled"),   # GIN's MLP, second layer
    (12288, 3, 100, "shallow"),  # the edge embedding
    (4096, 9, 100, "shallow"),   # the node encoder
    (1, 1040, 8, "narrow"),
    (37, 16, 9, "shallow"),
    (37, 17, 9, "tiled"),
    (37, 3, 8, "narrow"),
])
def test_node_mlp_variant(m, k, n, want):
    assert NM.variant(m, k, n) == want


@pytest.mark.parametrize("k, stages", [(0, 1), (3, 1), (32, 1), (100, 4), (200, 7),
                                       (256, 8), (1040, 8)])
def test_node_mlp_tiled_shared_memory_fits(k, stages):
    """One ring stage per 32-deep K slice, at most 8: K <= 256 in one go."""
    got = NM.tiled_smem_bytes(k)
    assert got == stages * NM.TILED_STAGE_BYTES == stages * 17_408
    assert got <= FM.MAX_SMEM_BYTES


def test_node_mlp_cpu_dispatch_counts_no_variant():
    x, w, b = torch.randn(5, 9), torch.randn(9, 3), torch.randn(3)
    before = (NM.launches, dict(NM.launches_by_variant))
    assert kops.node_mlp(x, w, b).shape == (5, 3)
    assert (NM.launches, NM.launches_by_variant) == before
    with pytest.raises(ValueError, match="CUDA"):
        NM.node_mlp(x, w, b)
    assert (NM.launches, NM.launches_by_variant) == before
