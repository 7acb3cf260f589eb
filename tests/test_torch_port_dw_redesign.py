"""The sparse-conv weight-gradient kernels K7/K10 of the port as
redesigned for the H100's tensor cores, checked on the CPU.

- A plain PyTorch model of the bf16 kernel's blocking, written here: row
  chunks of the flattened (B*Vout) axis, tiles of ``dw_tile`` columns of
  the flattened (k, c) axis that span several offsets (C=16: a tile of
  16 offsets and one of 11), stages of ``DW_RS`` rows with misses, rows
  past the chunk and columns past K*C zero-filled, fp32 sums per block,
  then the chunks' partials summed in the kernel's fixed order. It must
  give the JAX backward's dW (``_bwd`` / ``_ids_bwd``: the einsum over
  the rows that ``gather_rows_pallas`` / ``_idmatch_rows`` gather, here
  in interpret mode) at C=5 and C=16. Tolerance atol 1e-5: the inputs
  are bf16 values, so every product is exact in fp32 and only the order
  of the fp32 sums differs.
- ``dw_plan``: enough blocks to fill the card at every call shape of
  both presets, bounded partials, and the edge shapes.
- The Python mirror of the kernel's blocking equals the CUDA source's.
"""
import re
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke
from uni3detr_tpu.ops import sparse_conv as jsc
from uni3detr_tpu.ops import sparse_conv_pallas as jpl
from uni3detr_tpu_torch.models.sparse_encoder import SparseEncoderHD
from uni3detr_tpu_torch.ops import cuda_lib
from uni3detr_tpu_torch.ops import sparse_conv_cuda as tk
from uni3detr_tpu_torch.presets import NUSCENES, SUNRGBD

GRID = (6, 8, 10)
SUM_WAYS = 8          # warps of the kernel's chunk sum


def _round16(x):
    return -(-x // 16) * 16


def blocked_dw(feats, rows_of, g, chunk_rows):
    """The bf16 kernel's blocking in plain PyTorch. feats (B, V, C) and
    g (B, Vout, Cout) float32 holding bf16 values; rows_of (B, Vout, K)
    the resolved feature-table row (b * V + site) of each (row, offset),
    -1 for a miss. Returns dW (K, C, Cout) fp32."""
    B, V, C = feats.shape
    Cout = g.shape[2]
    K = rows_of.shape[2]
    M, R = K * C, B * rows_of.shape[1]
    table = feats.reshape(B * V, C)
    rows_of = rows_of.reshape(R, K)
    gf = g.reshape(R, Cout)
    tm = tk.dw_tile(Cout)[0]
    kt = min(K, (tm + C - 2) // C + 1)      # dw_tile_offsets
    n_chunks = -(-R // chunk_rows)
    partial = torch.zeros(n_chunks, M, Cout)
    for chunk in range(n_chunks):
        r_begin = chunk * chunk_rows
        r_end = min(r_begin + chunk_rows, R)
        for m0 in range(0, M, tm):
            k_lo = m0 // C
            nk = (min(m0 + tm, M) - 1) // C + 1 - k_lo
            assert nk <= kt
            ma = min(tm, _round16(M - m0))   # staged columns
            m = m0 + torch.arange(ma)
            real = m < M
            k = torch.where(real, m // C, k_lo)
            c = m % C
            acc = torch.zeros(ma, Cout)
            for r0 in range(r_begin, r_end, tk.DW_RS):
                r = r0 + torch.arange(tk.DW_RS)
                live = r < r_end
                rr = r.clamp(max=R - 1)
                # resolve: the stage's rows at the tile's offsets
                s_row = torch.where(live[:, None],
                                    rows_of[rr, k_lo:k_lo + nk], -1)
                row = s_row[:, k - k_lo]
                ok = (row >= 0) & real[None]
                a = torch.where(ok, table[row.clamp(min=0), c[None]], 0.0)
                gs = torch.where(live[:, None], gf[rr], 0.0)
                acc += a.T @ gs
            partial[chunk, m[real]] = acc[real]
    ways = [torch.zeros(M, Cout) for _ in range(SUM_WAYS)]
    for chunk in range(n_chunks):
        ways[chunk % SUM_WAYS] += partial[chunk]
    dw = torch.zeros(M, Cout)
    for w in ways:
        dw += w
    return dw.reshape(K, C, Cout)


def _sites(rng, n, V):
    D, H, W = GRID
    lin = np.sort(rng.choice(D * H * W, size=n, replace=False))
    coords = np.full((V, 3), -1, np.int32)
    coords[:n] = np.stack([lin // (H * W), (lin // W) % H, lin % W], -1)
    mask = np.zeros(V, bool)
    mask[:n] = True
    return jnp.asarray(coords), jnp.asarray(mask)


def _bf16_values(rng, shape, scale=1.0):
    x = (scale * rng.randn(*shape)).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _case(kind, C, Cout, B=2, V=150, n=140):
    """Inputs of a K7 (submanifold rulebook) or K10 (strided query ids)
    call at B=2 with extra misses, an all-miss row and an all-miss
    offset; R = B * Vout is no multiple of DW_RS."""
    rng = np.random.RandomState(C * 100 + Cout + (kind == "K10"))
    feats, index, ids = [], [], []
    for _ in range(B):
        cj, mj = _sites(rng, n, V)
        if kind == "K7":
            q = np.array(jsc.subm_neighbor_idx(cj, mj, GRID))
            miss = V
        else:
            oc, om, _ = jsc.downsample_sites(cj, mj, GRID, (1, 1, 1), 70)
            q = np.array(jsc.strided_query_ids(oc, om, GRID, (1, 1, 1)))
            ids.append(np.asarray(jsc.linear_ids(cj, mj, GRID)))
            miss = -1
        q[::9, 4] = miss
        q[3] = miss
        q[:, 11] = miss
        index.append(q)
        feats.append(_bf16_values(rng, (V, C)) * np.asarray(mj)[:, None])
    feats, index = np.stack(feats), np.stack(index)
    g = _bf16_values(rng, (B, index.shape[1], Cout), 0.1)
    return feats, index, (np.stack(ids) if ids else None), g


def _rows_of(kind, feats, index, ids):
    """The kernel's resolve step: feature-table rows, -1 for a miss."""
    B, V, _ = feats.shape
    idx = torch.from_numpy(index)
    if kind == "K10":
        idx = tk.match_positions_plain(torch.from_numpy(ids), idx, V)
    hit = (idx >= 0) & (idx < V)
    base = (torch.arange(B) * V)[:, None, None]
    return torch.where(hit, base + idx.long(), -1)


@pytest.mark.parametrize("chunking", ["stage", "plan"])
@pytest.mark.parametrize("C,Cout", [(5, 16), (16, 24)])
@pytest.mark.parametrize("kind", ["K7", "K10"])
def test_blocked_dw_model_matches_jax_backward(kind, C, Cout, chunking):
    """Chunks of one stage each (the last one partial) or the plan's
    chunking (K7, 300 rows: a 192-row and a 108-row chunk; K10, 140
    rows: one chunk of a 192-row plan)."""
    feats, index, ids, g = _case(kind, C, Cout)
    B, Vout, K = index.shape
    if kind == "K7":
        rows = jpl.gather_rows_pallas(jnp.asarray(feats), jnp.asarray(index),
                                      interpret=True)
    else:
        rows = jpl._idmatch_rows(jnp.asarray(feats), jnp.asarray(ids),
                                 jnp.asarray(index), interpret=True)
    ref = np.asarray(jnp.einsum("bvx,bvo->xo", rows.astype(jnp.float32),
                                jnp.asarray(g))).reshape(K, C, Cout)
    chunk_rows = (tk.DW_RS if chunking == "stage" else
                  tk.dw_plan(B, Vout, K, C, Cout, 132)["chunk_rows"])
    assert (B * Vout) % tk.DW_RS and (B * Vout) % chunk_rows
    got = blocked_dw(torch.from_numpy(feats),
                     _rows_of(kind, feats, index, ids),
                     torch.from_numpy(g), chunk_rows)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    assert np.abs(ref).max() > 0.1 and not got[11].any()
    if kind == "K7":
        plain = tk.gather_conv_dw_plain(*(torch.from_numpy(a) for a in (
            feats, index, g)))
    else:
        plain = tk.gather_conv_ids_dw_plain(*(torch.from_numpy(a) for a in (
            feats, ids, index, g)))
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-5)


def _train_dw_shapes(cfg, B=4):
    """(B, Vout, K, C, Cout) of every K7 and K10 call of a train step."""
    enc = SimpleNamespace(budget_shrink=cfg.encoder_budget_shrink,
                          budget_caps=cfg.encoder_budget_caps)
    V = cfg.max_voxels
    sizes = [V] + [SparseEncoderHD.stage_budget(enc, V, i) for i in range(3)]
    subm, strided = chip_smoke.conv_cases(cfg)
    return ([(B, sizes[i], 27, C, Cout) for i, C, Cout, _ in subm]
            + [(B, sizes[i], 27, C, Cout) for i, C, Cout, _ in strided])


@pytest.mark.parametrize("cfg", [SUNRGBD, NUSCENES], ids=["sunrgbd",
                                                          "nuscenes"])
def test_dw_plan_fills_the_card_at_preset_shapes(cfg):
    """Every call shape gets at least a wave of 132 blocks, no more than
    DW_BLOCKS_PER_SM a SM, partials within DW_PARTIAL_BYTES, and chunks
    of whole stages that cover the rows exactly."""
    shapes = _train_dw_shapes(cfg)
    assert len(shapes) == 8 and shapes[-1][3:] == (64, 128)
    for B, Vout, K, C, Cout in shapes:
        p = tk.dw_plan(B, Vout, K, C, Cout, 132)
        R = B * Vout
        tm, tn = tk.dw_tile(Cout)
        tiles = -(-K * C // tm) * -(-Cout // tn)
        assert p["blocks"] == p["n_chunks"] * tiles
        assert 132 <= p["blocks"] <= tk.DW_BLOCKS_PER_SM * 132 + tiles, p
        assert p["partial_bytes"] == p["n_chunks"] * 4 * K * C * Cout
        assert p["partial_bytes"] <= tk.DW_PARTIAL_BYTES
        assert p["chunk_rows"] % tk.DW_RS == 0
        assert p["chunk_rows"] >= tk.DW_MIN_STAGES * tk.DW_RS
        assert (p["n_chunks"] - 1) * p["chunk_rows"] < R <= \
            p["n_chunks"] * p["chunk_rows"]


@pytest.mark.parametrize("shape,want", [
    # no rows: no chunk, dW is zeroed
    ((1, 0, 27, 16, 16), dict(n_chunks=0, chunk_rows=64, blocks=0)),
    # one row: one chunk of one stage
    ((1, 1, 27, 16, 16), dict(n_chunks=1, chunk_rows=64, blocks=2)),
    # one row past DW_MIN_STAGES stages: two chunks of 3 stages
    ((1, 257, 27, 16, 16), dict(n_chunks=2, chunk_rows=192, blocks=4)),
    # a (K, C, Cout) tile larger than the partial budget: one chunk
    ((4, 90000, 27, 512, 512), dict(n_chunks=1, chunk_rows=360000,
                                    blocks=108 * 4)),
    # Cout past 128: two channel tiles of two column tiles; the partial
    # budget (142 chunks of 117504 bytes) binds before the blocks wanted
    ((4, 20000, 27, 8, 136), dict(n_chunks=139, chunk_rows=576,
                                  blocks=139 * 2 * 2)),
])
def test_dw_plan_edge_shapes(shape, want):
    p = tk.dw_plan(*shape, sms=132)
    assert {k: p[k] for k in want} == want


@pytest.mark.parametrize("Cout", [1, 16, 17, 32, 33, 64, 65, 128, 200])
def test_dw_tile_matches_cuda_dispatch(Cout):
    """dw_tile, DW_RS and the chunk sum's ways equal what
    csrc/sparse_conv.cu launches: the first ``U3D_DW(WN, MSUB, NTW)``
    whose Cout bound holds gives TM = 16 MSUB (DW_WARPS / WN) and TN =
    8 NTW WN."""
    src = (cuda_lib.CSRC / "sparse_conv.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("DW_RS") == tk.DW_RS and const("SUM_WAYS") == SUM_WAYS
    warps = const("DW_WARPS")
    body = src[src.index("int launch_gather_conv_dw_bf16("):]
    cases = re.findall(r"(?:if \(Cout <= (\d+)\) )?U3D_DW\((\d+), (\d+), "
                       r"(\d+)\);", body)
    assert len(cases) == 4 and cases[-1][0] == ""
    for bound, wn, msub, ntw in cases:
        if bound == "" or Cout <= int(bound):
            wn, msub, ntw = int(wn), int(msub), int(ntw)
            assert tk.dw_tile(Cout) == (16 * msub * warps // wn, 8 * ntw * wn)
            assert msub * ntw * 4 <= 64       # fp32 sums a thread holds
            break
