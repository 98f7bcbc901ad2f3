"""The design of the fused kernels K1 and K2 (``csrc/fused_forward.cu``) on
the CPU: its arithmetic, its cluster's row ranges, its layout and banks.

The kernels run only on the card (``tests/test_torch_fused_cuda.py``).
Here a torch emulation takes the kernel's arithmetic step by step: each
f32 operand split exactly into three bfloat16 terms (``split_bf16x3``, the
kernel's register split), six of the nine products a k16 step in the
kernel's order (``SPLIT_PRODUCTS``: the five small ones into a float32
fragment of their own, hi·hi into the dot, the two added at the end), every
rank of a graph's cluster computing only its own rows, GCN's degrees and
both kernels' pool from each rank's partial sums added in rank order.  It
holds JAX's ``fused_*_forward(..., interpret=True)`` (the Pallas kernel
under its interpreter, as ``tests/test_torch_fused.py`` runs it) at rtol
1e-4 / atol 1e-5, the repository's f32 gate, for every cluster size the
rule can pick at each n.  The emulation's float32 sums of 16 products stand
for the tensor cores' own, whose order is not specified.

Then the wrapper's cluster-size rule, an emulation of the kernels' row
ranges (``rank_rows``) and shared-memory layout (``make_layout``, which the
CUDA source alone owns): every shape ``forward_auto``'s routing rule admits
fits it, and ``tests/test_torch_fused_cuda.py`` holds the emulation to the
source's own ``cgt_fused_smem_bytes`` on the card.  Last, a numpy emulation
of the banks of every fragment load and store at node counts and widths of
64, 88 and 128.
"""

import functools
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.models as jm
import connectome_gnn_tpu_torch.models as tm
from connectome_gnn_tpu.ops import fused_pallas as jf
from connectome_gnn_tpu_torch.ops import fused as tf
from connectome_gnn_tpu_torch.ops.band_mma import SPLIT_PRODUCTS, split_bf16x3

RTOL, ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "connectome_gnn_tpu_torch", "csrc", "fused_forward.cu")
#: (B, n, F, H, L)
SHAPES = [(3, 24, 5, 32, 2), (2, 88, 5, 64, 3), (1, 128, 5, 128, 1)]
CASES = [(kind, shape, cs) for kind in ("gcn", "sage") for shape in SHAPES
         for cs in range(1, min(tf.MAX_CLUSTER, -(-shape[1] // 16)) + 1)]
KINDS = {"gcn": (jm.GCNConnectome, tm.GCNConnectome, jf.fused_gcn_forward, tf.gcn_weights),
         "sage": (jm.GraphSAGEConnectome, tm.GraphSAGEConnectome, jf.fused_sage_forward,
                  tf.sage_weights)}


# ---------------------------------------------------------------------------
# The emulation
# ---------------------------------------------------------------------------


def split_sum(pairs) -> torch.Tensor:
    """``sum A @ B`` over ``pairs`` of float32 ``(A [.., M, K], B [.., K, N])``
    as the kernel takes it: K in k16 steps (zeros past K), each operand split
    into three bfloat16 terms, per step the five small products into
    ``corr`` and hi·hi into ``dot`` (float32 fragments that run on across
    the pairs), ``dot + corr`` at the end."""
    dot = corr = 0.0
    for A, B in pairs:
        K = A.shape[-1]
        pad = -K % 16
        a = split_bf16x3(torch.nn.functional.pad(A, (0, pad))).float()
        b = split_bf16x3(torch.nn.functional.pad(B, (0, 0, 0, pad))).float()
        for k0 in range(0, K + pad, 16):
            ak, bk = a[..., k0:k0 + 16], b[..., k0:k0 + 16, :]
            for i, j in SPLIT_PRODUCTS[:-1]:
                corr = corr + ak[i] @ bk[j]
            dot = dot + ak[0] @ bk[0]
    return dot + corr


def cluster_rows(n, cs):
    """Receiver rows ``[r0, r1)`` of each rank of a graph's cluster, as the
    kernel's ``rank_rows`` gives them: whole m16 tiles, as even as can be,
    the first ``T % cs`` ranks one tile more."""
    T = -(-n // 16)
    q, rem = divmod(T, cs)
    rows, t0 = [], 0
    for r in range(cs):
        t1 = t0 + q + (r < rem)
        rows.append((16 * t0, min(16 * t1, n)))
        t0 = t1
    return rows


def in_rank_order(parts):
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pool_and_head(h, mask, w, ranks):
    """Each rank's masked column sums and count over its rows, added by
    rank 0 in rank order; then the head in plain float32."""
    m = mask.float()
    sums = in_rank_order([(h[:, r0:r1] * m[:, r0:r1, None]).sum(1) for r0, r1 in ranks])
    count = in_rank_order([m[:, r0:r1].sum(1) for r0, r1 in ranks])
    pooled = sums / (count[:, None] + tf.EPS)
    return torch.relu(pooled @ w.w1 + w.b1) @ w.w2 + w.b2


def emulate_gcn(x, adj, mask, w, cs):
    ranks = cluster_rows(x.shape[1], cs)
    deg = in_rank_order([adj[:, r0:r1, :].sum(1) for r0, r1 in ranks])  # column sums
    dinv = torch.rsqrt(deg + 1.0 + tf.EPS)
    adj_n = dinv[:, :, None] * adj * dinv[:, None, :]
    h = x
    for layer in range(w.scale.shape[0]):
        W = w.w_in if layer == 0 else w.w_h[layer - 1]
        # each rank's rows of hw, stored into every rank: all of hw
        hw = torch.cat([split_sum([(h[:, r0:r1], W)]) for r0, r1 in ranks], dim=1)
        h = torch.cat([
            torch.relu((split_sum([(adj_n[:, r0:r1], hw)])
                        + (dinv[:, r0:r1] * dinv[:, r0:r1])[:, :, None] * hw[:, r0:r1])
                       * w.scale[layer] + w.shift[layer])
            for r0, r1 in ranks], dim=1)
    return pool_and_head(h, mask, w, ranks)


def emulate_sage(x, adj, mask, w, cs):
    ranks = cluster_rows(x.shape[1], cs)
    wsum = adj.sum(2, keepdim=True) + tf.EPS  # row sums, each rank its own
    h = x
    for layer in range(w.scale.shape[0]):
        Ws = w.w_self_in if layer == 0 else w.w_self_h[layer - 1]
        Wa = w.w_agg_in if layer == 0 else w.w_agg_h[layer - 1]
        rows = []
        for r0, r1 in ranks:
            agg = split_sum([(adj[:, r0:r1], h)]) / wsum[:, r0:r1]
            z = split_sum([(h[:, r0:r1], Ws), (agg, Wa)])
            rows.append(torch.relu(z + w.bias[layer]) * w.scale[layer] + w.shift[layer])
        h = torch.cat(rows, dim=1)  # every rank's rows into every rank's h
    return pool_and_head(h, mask, w, ranks)


EMULATE = {"gcn": emulate_gcn, "sage": emulate_sage}


@functools.cache
def jax_params(kind, hidden, layers):
    """JAX parameters with non-trivial BatchNorm state (one train-mode
    forward), and the port's model with them."""
    jcls, tcls, _, _ = KINDS[kind]
    jbatch = jd.collate_dense(jd.generate_dataset(num_subjects=6, num_regions=18, seed=4))
    jmodel = jcls(in_channels=5, hidden_dim=hidden, num_layers=layers)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    _, state = jmodel.apply(params, state, jbatch, train=True, rng=jax.random.PRNGKey(1))
    model = tcls(in_channels=5, hidden_dim=hidden, num_layers=layers)
    tm.load_jax_params(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, state))
    return params, state, model.eval()


def random_inputs(B, n, F, seed=0):
    """A directed adjacency (~30 % dense) and ragged masks, from numpy."""
    rng = np.random.default_rng(seed)
    mask = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, size=B)[:, None]
    x = rng.normal(size=(B, n, F)).astype(np.float32) * mask[:, :, None]
    adj = rng.beta(2, 5, (B, n, n)) * (rng.random((B, n, n)) < 0.3)
    adj = (adj * mask[:, :, None] * mask[:, None, :]).astype(np.float32)
    return x, adj, mask


@functools.cache
def pallas_logits(kind, shape):
    B, n, F, H, L = shape
    params, state, _ = jax_params(kind, H, L)
    x, adj, mask = random_inputs(B, n, F)
    return np.asarray(KINDS[kind][2](params, state, x, adj, mask, num_layers=L, interpret=True))


@pytest.mark.parametrize("kind,shape,cs", CASES, ids=[f"{k}-n{s[1]}-H{s[3]}-cs{c}" for k, s, c in CASES])
def test_emulated_kernel_matches_pallas_interpret(kind, shape, cs):
    B, n, F, H, L = shape
    _, _, model = jax_params(kind, H, L)
    w = KINDS[kind][3](model)
    x, adj, mask = (torch.from_numpy(a) for a in random_inputs(B, n, F))
    got = EMULATE[kind](x, adj, mask, w, cs)
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), pallas_logits(kind, shape), rtol=RTOL, atol=ATOL)


def test_six_products_give_the_float32_product():
    """The split products over a K of 88 stay within 1e-6 of the float64
    product of the float32 operands, the gate the band's f32 split holds."""
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.normal(size=(16, 88)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(88, 64)).astype(np.float32))
    want = A.double() @ B.double()
    got = split_sum([(A, B)]).double()
    scale = A.double().abs() @ B.double().abs()
    assert float(((got - want).abs() / scale).max()) < 1e-6


# ---------------------------------------------------------------------------
# The cluster rule and the row ranges
# ---------------------------------------------------------------------------


def test_cluster_size_at_the_main_shapes():
    assert tf.cluster_size(16, 88, 132) == 6
    assert tf.cluster_size(1, 88, 132) == 6
    assert tf.cluster_size(512, 88, 132) == 1
    assert tf.cluster_size(132, 88, 132) == 2
    assert tf.cluster_size(133, 88, 132) == 1
    assert tf.cluster_size(7, 128, 132) == 8
    assert [tf.cluster_size(B, 88, 132) for B in (44, 45, 52, 53, 66, 67, 88, 89)] == [6, 5, 5, 4, 4, 3, 3, 2]


@pytest.mark.parametrize("sm_count", [1, 16, 132])
def test_cluster_size_is_the_largest_within_its_limits(sm_count):
    for n in range(1, 129):
        top = min(tf.MAX_CLUSTER, -(-n // 16))
        for B in range(1, 600, 7):
            cs = tf.cluster_size(B, n, sm_count)
            assert 1 <= cs <= top
            assert cs == 1 or B * cs <= tf.BLOCKS_PER_SM * sm_count
            assert cs == top or B * (cs + 1) > tf.BLOCKS_PER_SM * sm_count


def test_the_rule_has_no_user_setting():
    import inspect

    assert list(inspect.signature(tf.cluster_size).parameters) == ["B", "n", "sm_count"]
    assert list(inspect.signature(tf.fused_gcn_kernel).parameters) == ["x", "adj", "node_mask", "w"]
    assert list(inspect.signature(tf.fused_sage_kernel).parameters) == ["x", "adj", "node_mask", "w"]
    src = open(os.path.join(REPO, "connectome_gnn_tpu_torch", "ops", "fused.py")).read()
    assert "environ" not in src


@pytest.mark.parametrize("n", [1, 5, 16, 24, 40, 87, 88, 100, 128])
def test_cluster_rows_own_every_row_once_in_whole_tiles(n):
    for cs in range(1, min(tf.MAX_CLUSTER, -(-n // 16)) + 1):
        rows = cluster_rows(n, cs)
        assert len(rows) == cs
        owned = np.concatenate([np.arange(r0, r1) for r0, r1 in rows])
        np.testing.assert_array_equal(owned, np.arange(n))  # once each, in rank order
        for r, (r0, r1) in enumerate(rows):
            assert r1 > r0 and r0 % 16 == 0
            assert (r1 - r0) % 16 == 0 or r == cs - 1 and r1 == n
        sizes = [-(-(r1 - r0) // 16) for r0, r1 in rows]
        assert max(sizes) - min(sizes) <= 1


# ---------------------------------------------------------------------------
# Shared memory: the routing rule and the kernels' layout
# ---------------------------------------------------------------------------


def a_stride(w):
    """The adjacency's padded row stride: 4 mod 8 floats (``a_stride``)."""
    return w + ((4 - w) & 7)


def pair_stride(w):
    """A feature array's padded row stride: 8 mod 16 floats (``pair_stride``)."""
    return w + ((8 - w) & 15)


def _pad(x, m):
    return -(-x // m) * m


def layout_bytes(kind, n, F, H, H2, cs, padded):
    """``layout_with``'s total in bytes (numpy arrays of H and H2 welcome):
    no row padded to a tile, R the most rows a rank owns; the strides
    padded (and each region 16-byte aligned) or the widths themselves, and
    then 8 floats of slack for the B rows read to their n8 tile's end."""
    T, D, align = -(-n // 16), np.maximum(F, H), 4 if padded else 1
    R = min(16 * -(-T // cs), n)
    Sa = a_stride(n) if padded else n
    Sh = pair_stride(D) if padded else D
    Sw = pair_stride(H) if padded else H
    h = _pad(R * Sa, align)
    if kind == "gcn":  # own rows of h, every row of hw, dinv
        end = _pad(_pad(_pad(h + R * Sh, align) + n * Sw, align) + n, align)
    else:  # every row of h, own rows of the aggregate, z's tile, wsum
        end = _pad(_pad(_pad(_pad(h + n * Sh, align) + R * Sh, align) + 16 * Sw, align) + R, align)
    return 4 * (end + H2 + (0 if padded else 8))


def smem_bytes(kind, n, F, H, H2, cs=1):
    """``make_layout``'s total: the padded layout where it fits, else the
    compact one; and whether it is the padded one."""
    padded = layout_bytes(kind, n, F, H, H2, cs, True)
    fits = padded <= tf.SMEM_LIMIT_BYTES
    return np.where(fits, padded, layout_bytes(kind, n, F, H, H2, cs, False)), fits


#: (kind, n, F, H, H2, cs) -> the layout's bytes, as cgt_fused_smem_bytes
#: gives them (tests/test_torch_fused_cuda.py holds the source to these)
LAYOUT_BYTES = {("gcn", 88, 5, 64, 32, 1): 83552, ("sage", 88, 5, 64, 32, 1): 88160,
                ("gcn", 88, 5, 64, 32, 6): 36320, ("sage", 88, 5, 64, 32, 6): 40640,
                ("gcn", 128, 5, 128, 64, 1): 207616, ("sage", 128, 5, 128, 64, 1): 216320,
                ("gcn", 128, 5, 161, 80, 1): 231264, ("sage", 128, 5, 151, 75, 1): 230668,
                ("gcn", 40, 7, 37, 18, 3): 12008, ("sage", 24, 5, 264, 132, 2): 61520}


def test_layout_bytes_at_a_few_shapes():
    """The emulation's totals at the main shapes, at clusters, at the
    compact layout (n = 128, H = 161 and 151) and at odd widths: the
    numbers the card test checks the source's count against."""
    for (kind, n, F, H, H2, cs), want in LAYOUT_BYTES.items():
        got, padded = smem_bytes(kind, n, F, H, H2, cs)
        assert int(got) == want, (kind, n, F, H, cs, int(got))
        assert bool(padded) == (H not in (161, 151)), (kind, n, H)


def old_smem_bytes(kind, n, F, H, H2):
    """The first design's byte count (one block, unpadded rows)."""
    D = np.maximum(F, H)
    if kind == "gcn":
        return 4 * (n * n + n * D + n * H + 2 * n + H + H2)
    return 4 * (n * n + 2 * n * D + 16 * H + 2 * n + H + H2)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_forward_auto_routes_the_same_shapes_up_to_width_128(kind):
    """The routing rule's count is the first design's, and every shape with
    n <= 128, F <= 16 and H <= 128 fits the padded layout."""
    for n in range(1, tf.MAX_FUSED_NODES + 1):
        for F in (1, 3, 5, 8, 16):
            H = np.arange(8, 129, 4)
            routing = [tf.smem_bytes(kind, n, F, int(h), int(h) // 2) for h in H]
            assert routing == old_smem_bytes(kind, n, F, H, H // 2).tolist()
            assert (old_smem_bytes(kind, n, F, H, H // 2) <= tf.SMEM_LIMIT_BYTES).all()
            assert smem_bytes(kind, n, F, H, H // 2)[1].all(), (kind, n, F)
    assert tf.smem_bytes(kind, 128, 5, 256, 128) > tf.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_every_shape_the_routing_rule_admits_fits_the_layout(kind):
    """For n = 1..128, F in 1..39 and some wider, and every H the routing
    rule admits (the model's head of H // 2), the layout fits one block at
    every cluster size; and where the compact layout is taken it never takes
    more than the routing rule counts."""
    H = np.arange(1, 20_000)
    for n in range(1, tf.MAX_FUSED_NODES + 1):
        for F in [*range(1, 40), 64, 100, 128, 200, 513, 1000, 5000, 20_000]:
            routed = H[old_smem_bytes(kind, n, F, H, H // 2) <= tf.SMEM_LIMIT_BYTES]
            if not len(routed):
                continue
            got, padded = smem_bytes(kind, n, F, routed, routed // 2)
            assert (got[~padded] <= old_smem_bytes(kind, n, F, routed, routed // 2)[~padded]).all(), (kind, n, F)
            for cs in range(1, min(tf.MAX_CLUSTER, -(-n // 16)) + 1):
                assert (smem_bytes(kind, n, F, routed, routed // 2, cs)[0] <= tf.SMEM_LIMIT_BYTES).all()


def test_smem_fits_chip_smokes_shapes_at_every_cluster_size():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    shapes = [(kind, s) for s in chip_smoke.SHAPES for kind in ("gcn", "sage")]
    shapes += [(kind, s) for kind, s in chip_smoke.COMPACT_SHAPES.items()]
    for kind, (B, n, F, H, L) in shapes:
        assert tf.smem_bytes(kind, n, F, H, H // 2) <= tf.SMEM_LIMIT_BYTES
        full = int(smem_bytes(kind, n, F, H, H // 2)[0])
        assert full <= tf.SMEM_LIMIT_BYTES
        for cs in range(2, min(tf.MAX_CLUSTER, -(-n // 16)) + 1):
            assert int(smem_bytes(kind, n, F, H, H // 2, cs)[0]) <= full
    for kind, (B, n, F, H, L) in chip_smoke.COMPACT_SHAPES.items():  # they take the compact layout
        assert tf.cluster_size(B, n, 132) == 1 and not smem_bytes(kind, n, F, H, H // 2)[1]


def test_the_kernel_bodies_use_mma_sync_and_no_tf32():
    """The products are bf16 mma.sync over the split; the kernels' bodies
    hold no TF32, no wgmma and no library call."""
    src = open(SOURCE).read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert '#include "bf16_split.cuh"' in src
    body = src[src.index("__global__"):]
    assert not re.search(r"tf32|wgmma|cublas|matmul", body, re.IGNORECASE)


# ---------------------------------------------------------------------------
# Banks
# ---------------------------------------------------------------------------


def wavefronts(addresses, width) -> int:
    """Shared-memory wavefronts of one warp's access of ``width`` bytes a
    lane at float ``addresses`` (lane order): the lanes go in phases of
    128 / width bytes' worth (32, 16 or 8 lanes), and a phase takes as many
    wavefronts as the most distinct 32-bit words any bank is asked for."""
    lanes = 128 // width
    words = width // 4
    total = 0
    for p in range(0, 32, lanes):
        per_bank = {}
        for a in addresses[p:p + lanes]:
            for w in range(a, a + words):
                per_bank.setdefault(w % 32, set()).add(w)
        total += max(len(v) for v in per_bank.values())
    return total


LANES = [(lane >> 2, lane & 3) for lane in range(32)]


def fragment_accesses(n, width):
    """Every warp-wide fragment access of the kernel, ``(what, width in
    bytes, float addresses)``, at ``n`` nodes and ``width`` features, for
    each k16 step and n8 tile (the unit's first row at 0)."""
    Sa, S = a_stride(n), pair_stride(width)
    out = []
    for kk in range(0, -(-max(n, width) // 16) * 16, 16):
        for row in (0, 8):  # w_product's A: 8-byte loads at 2t, 2t + 8
            for off in (0, 8):
                out.append(("w_product A", 8, [(g + row) * S + kk + 2 * t + off for g, t in LANES]))
        for row in (0, 8):  # adj_product's A: senders t + 4s
            for s in range(4):
                out.append(("adj_product A", 4, [(g + row) * Sa + kk + t + 4 * s for g, t in LANES]))
        for j in range(width // 8):  # adj_product's B: rows t + 4s, column 8j + g
            for s in range(4):
                out.append(("adj_product B", 4, [(kk + t + 4 * s) * S + 8 * j + g for g, t in LANES]))
    for j in range(width // 8):  # finish: 8-byte stores of rows g, g + 8
        for row in (0, 8):
            out.append(("epilogue store", 8, [(g + row) * S + 8 * j + 2 * t for g, t in LANES]))
    return out


@pytest.mark.parametrize("size", [64, 88, 128])
def test_every_fragment_access_takes_the_fewest_wavefronts(size):
    """At n = size and H = size (64, 88, 128 nodes or features), every load
    and store of a fragment takes one wavefront per 128 bytes: 1 for 4-byte
    accesses, 2 for 8-byte ones."""
    for what, width, addresses in fragment_accesses(size, size):
        assert wavefronts(addresses, width) == width // 4, (what, size)


def test_unpadded_strides_would_conflict():
    """The padding is what buys that: at the raw strides (64 and 128 floats,
    or 88 for the adjacency) the 8 rows of a fragment share banks."""
    lanes = LANES
    for S, want in ((64, 8), (128, 8)):  # w_product's A, 4 rows a phase in one bank
        assert wavefronts([g * S + 2 * t for g, t in lanes], 8) == want
    assert wavefronts([g * 88 + t for g, t in lanes], 4) == 2  # adj_product's A
    assert wavefronts([(t + 0) * 64 + g for g, t in lanes], 4) == 4  # adj_product's B
