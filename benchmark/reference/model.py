"""The plain reference of Uni3DETR's Lidar detector (fp32, plain PyTorch).

Hard voxelization with the mean VFE, the depth-preserving sparse encoder
as gathers and products over its own rulebooks, SECOND3D + FPN, paired
D-FPS query seeds and the grouped DAB decoder with volume
cross-attention, after Uni3DETR (zhenyuw16/Uni3DETR,
``projects/mmdet3d_plugin``). The module and parameter names are those of
the reference checkpoint, so one ``state_dict`` loads here and into the
system under test. Nothing here is fast: sites are found by sorting and
searching, convolutions gather every tap, FPS is a Python loop.

``quant`` (a :class:`Precision`) rounds, as a configuration computes:
where its ``compute_dtype`` rounds a tensor (the voxel features and
weights of the sparse convs and their outputs, the volumes, SECOND3D's
activations, the sampling coordinates) and, apart, the dense convs'
weights, which the system under test runs in fp32 on TF32. The identity
for the reference; one precision lower at each for the comparison's
control (``quantizer``).
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .geometry import inverse_sigmoid

INT_MAX = 2 ** 31 - 1


# -- precision of the control ------------------------------------------------

class _RoundFp8(torch.autograd.Function):
    """Round to float8 e4m3 (saturating at 448) in the forward and the
    gradient to e5m2 (saturating at 57344), the usual fp8 recipe; values
    stay in fp32 tensors."""

    @staticmethod
    def forward(ctx, x):
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-57344.0, 57344.0).to(torch.float8_e5m2).to(g.dtype)


def _identity(x):
    return x


def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


class Precision:
    """``act`` rounds what the configuration computes in ``compute_dtype``;
    ``dense`` the dense convs' weights."""

    def __init__(self, act, dense):
        self.act, self.dense = act, dense

    def __call__(self, x):
        return self.act(x)


def quantizer(precision: str) -> Precision:
    """``float32``: the reference, no rounding. ``float8``: the control, one
    precision below the configuration's everywhere: float8
    (:class:`_RoundFp8`) for bf16, bf16 for the dense convs' fp32 on TF32
    (and TF32 for the head's fp32 products, set by the caller).
    ``float8_alone``: the second control, float8 where the configuration
    computes in bf16 and nothing else lowered (the step a program that
    ran its bf16 parts in float8 would take). ``bfloat16``: bf16 where
    the configuration computes in it, the witness of the rounding the
    system under test does."""
    if precision == "float32":
        return Precision(_identity, _identity)
    if precision == "float8":
        return Precision(_RoundFp8.apply, _bf16)
    if precision == "float8_alone":
        return Precision(_RoundFp8.apply, _identity)
    if precision == "bfloat16":
        return Precision(_bf16, _identity)
    raise ValueError(f"unknown precision {precision!r}")


# -- voxels and sites --------------------------------------------------------

def voxelize(points, cfg, max_voxels):
    """One scene (P, C) -> feats (V, C) fp32, coords (V, 3) long (z, y,
    x), mask (V,): the voxels in ascending linear id, each the mean of its
    first ``max_points_per_voxel`` points in input order, cut at
    ``max_voxels`` voxels; padding rows last (coords -1)."""
    D, H, W = cfg["grid_size"]
    lo = torch.tensor(cfg["pc_range"][:3], device=points.device)
    inv = torch.tensor(cfg["voxel_size"], dtype=torch.float32).reciprocal()
    idx = torch.floor((points[:, :3] - lo) * inv.to(points.device)).long()
    ix, iy, iz = idx.unbind(-1)
    ok = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H) & (iz >= 0) & (iz < D)
    lin = (iz * H + iy) * W + ix
    pts = points[ok].double()
    lin = lin[ok]
    uniq, inv_idx = torch.unique(lin, sorted=True, return_inverse=True)
    order = torch.sort(inv_idx, stable=True).indices
    seg = inv_idx[order]
    start = torch.searchsorted(seg, torch.arange(len(uniq),
                                                 device=seg.device))
    rank = torch.arange(len(seg), device=seg.device) - start[seg]
    keep = rank < cfg["max_points_per_voxel"]
    nvox = min(len(uniq), max_voxels)
    keep &= seg < nvox
    sums = torch.zeros(nvox, pts.shape[1], dtype=torch.float64,
                       device=points.device)
    sums.index_add_(0, seg[keep], pts[order][keep])
    cnt = torch.bincount(seg[keep], minlength=nvox).clamp(min=1)
    feats = torch.zeros(max_voxels, pts.shape[1], device=points.device)
    feats[:nvox] = (sums / cnt[:, None]).float()
    coords = torch.full((max_voxels, 3), -1, dtype=torch.long,
                        device=points.device)
    u = uniq[:nvox]
    coords[:nvox] = torch.stack([u // (H * W), (u // W) % H, u % W], -1)
    mask = torch.zeros(max_voxels, dtype=torch.bool, device=points.device)
    mask[:nvox] = True
    return feats, coords, mask


def lin_ids(coords, mask, grid):
    D, H, W = grid
    lin = (coords[:, 0] * H + coords[:, 1]) * W + coords[:, 2]
    return torch.where(mask, lin, torch.full_like(lin, INT_MAX))


def offsets(device):
    r = torch.arange(3, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        27, 3)


def stage_budget(cfg, V, i):
    budget = -(-int(V * cfg["encoder_budget_shrink"][i]) // 8) * 8
    caps = cfg.get("encoder_budget_caps")
    if caps is not None:
        budget = min(budget, caps[i])
    return max(budget, 256)


def downsample(coords, mask, grid, pad, budget):
    """The output sites of a stride-2, 3x3x3 conv: every output one of
    whose taps lands on an input site, ascending by id, cut at
    ``budget``."""
    out_grid = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
    c = coords[mask]
    padt = torch.tensor(pad, device=c.device)
    cand = (c[:, None, :] + padt - offsets(c.device)[None])   # (n, 27, 3)
    ok = ((cand % 2 == 0).all(-1) & (cand >= 0).all(-1))
    o = torch.div(cand, 2, rounding_mode="floor")
    og = torch.tensor(out_grid, device=c.device)
    ok &= (o < og).all(-1)
    o = o[ok]
    Do, Ho, Wo = out_grid
    lin = torch.unique((o[:, 0] * Ho + o[:, 1]) * Wo + o[:, 2], sorted=True)
    lin = lin[:budget]
    n = len(lin)
    oc = torch.full((budget, 3), -1, dtype=torch.long, device=c.device)
    oc[:n] = torch.stack([lin // (Ho * Wo), (lin // Wo) % Ho, lin % Wo], -1)
    om = torch.zeros(budget, dtype=torch.bool, device=c.device)
    om[:n] = True
    return oc, om, out_grid


def neighbours(site_coords, site_mask, grid, out_coords, out_mask, stride,
               pad):
    """(Vout, 27) row of the input site at each tap of each output, or
    the number of input rows where there is none. Submanifold
    (``stride`` 1): tap = out + off - 1; strided: tap = 2 out - pad +
    off."""
    D, H, W = grid
    ids = lin_ids(site_coords, site_mask, grid)
    off = offsets(out_coords.device)
    if stride == 1:
        tap = out_coords[:, None, :] + off[None] - 1
    else:
        tap = out_coords[:, None, :] * 2 - torch.tensor(
            pad, device=off.device) + off[None]
    inb = ((tap >= 0).all(-1) & (tap[..., 0] < D) & (tap[..., 1] < H)
           & (tap[..., 2] < W) & out_mask[:, None])
    q = (tap[..., 0] * H + tap[..., 1]) * W + tap[..., 2]
    pos = torch.searchsorted(ids, q.clamp(min=0).reshape(-1)).reshape(
        q.shape).clamp(max=len(ids) - 1)
    hit = inb & (ids[pos] == q)
    return torch.where(hit, pos, torch.full_like(pos, len(ids)))


def site_sets(cfg, coords, mask):
    """Per scene: the site set of every stage and the rulebooks of its
    convs."""
    grid = tuple(cfg["grid_size"])
    V = coords.shape[0]
    sets = [dict(coords=coords, mask=mask, grid=grid)]
    for i in range(len(cfg["encoder_channels"]) - 1):
        p = sets[-1]
        pad = tuple(cfg["encoder_downsample_paddings"][i])
        c, m, g = downsample(p["coords"], p["mask"], p["grid"], pad,
                             stage_budget(cfg, V, i))
        sets.append(dict(coords=c, mask=m, grid=g,
                         down=neighbours(p["coords"], p["mask"], p["grid"],
                                         c, m, 2, pad)))
    for s in sets:
        s["subm"] = neighbours(s["coords"], s["mask"], s["grid"],
                               s["coords"], s["mask"], 1, None)
    return sets


# -- sparse encoder ----------------------------------------------------------

def gather_conv(x, nb, w, quant):
    """x (B, V, C); nb (B, Vout, 27) rows, V for none; w (3, 3, 3, C,
    Cout) -> (B, Vout, Cout): every tap gathered, one fp32 product."""
    B, V, C = x.shape
    xp = torch.cat([x, x.new_zeros(B, 1, C)], 1)
    rows = xp[torch.arange(B, device=x.device)[:, None, None], nb]
    out = rows.reshape(B, nb.shape[1], 27 * C) @ quant(w).reshape(27 * C, -1)
    return quant(out)


class SparseConvWeight(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k, k, k, cin, cout))


@torch.no_grad()
def _track(bn, mean, var):
    """Running statistics move by ``momentum`` towards the batch's mean and
    biased variance (flax's rule, as the reference trains)."""
    bn.running_mean.lerp_(mean, bn.momentum)
    bn.running_var.lerp_(var, bn.momentum)


class MaskedBN(nn.BatchNorm1d):
    """BatchNorm over the valid rows of (B, V, C), eps 1e-3: batch
    statistics (biased variance) in training, running ones in eval."""

    def __init__(self, c):
        super().__init__(c, eps=1e-3, momentum=0.01)

    def forward(self, x, mask):
        m = mask[..., None].float()
        if self.training:
            n = m.sum().clamp(min=1.0)
            mean = (x * m).sum((0, 1)) / n
            var = (((x - mean) ** 2) * m).sum((0, 1)) / n
            _track(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y * m


class BasicBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1, self.bn1 = SparseConvWeight(c, c), MaskedBN(c)
        self.conv2, self.bn2 = SparseConvWeight(c, c), MaskedBN(c)

    def forward(self, x, nb, mask, quant):
        y = quant(torch.relu(self.bn1(gather_conv(x, nb, self.conv1.weight,
                                                  quant), mask)))
        y = self.bn2(gather_conv(y, nb, self.conv2.weight, quant), mask)
        return quant(torch.relu(y + x))


def _conv_bn(cin, cout, k=3):
    return nn.ModuleList([SparseConvWeight(cin, cout, k), MaskedBN(cout),
                          nn.ReLU()])


class SparseEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        base = cfg["encoder_base_channels"]
        self.conv_input = _conv_bn(cfg["in_point_features"], base)
        layers, cin = {}, base
        chans = cfg["encoder_channels"]
        for i, blocks in enumerate(chans):
            strided = i < len(chans) - 1
            mods = [BasicBlock(c) for c in (blocks[:-1] if strided
                                            else blocks)]
            if strided:
                mods.append(_conv_bn(cin, blocks[-1]))
                cin = blocks[-1]
            layers[f"encoder_layer{i + 1}"] = nn.ModuleList(mods)
        self.encoder_layers = nn.ModuleDict(layers)
        self.conv_out = _conv_bn(cin, cfg["encoder_out_channels"], 1)

    def forward(self, feats, sets_per_scene, quant):
        """feats (B, V, C) fp32; one site-set list per scene -> the dense
        volume (B, D', H', W', Cout) fp32 and its grid."""
        B = feats.shape[0]
        n = len(sets_per_scene[0])
        st = lambda i, k: torch.stack([s[i][k] for s in sets_per_scene])
        x = quant(feats)
        for i in range(n):
            mask = st(i, "mask")
            mods = self.encoder_layers[f"encoder_layer{i + 1}"]
            if i == 0:
                conv, bn, _ = self.conv_input
                x = gather_conv(x, st(0, "subm"), conv.weight, quant)
            else:
                conv, bn, _ = self.encoder_layers[f"encoder_layer{i}"][-1]
                x = gather_conv(x, st(i, "down"), conv.weight, quant)
            x = quant(torch.relu(bn(x, mask)))
            for blk in (mods if i == n - 1 else mods[:-1]):
                x = blk(x, st(i, "subm"), mask, quant)
        conv, bn, _ = self.conv_out
        mask = st(n - 1, "mask")
        x = torch.relu(bn(x @ conv.weight[0, 0, 0], mask))
        grid = sets_per_scene[0][-1]["grid"]
        D, H, W = grid
        vol = x.new_zeros(B, D * H * W + 1, x.shape[-1])
        c = st(n - 1, "coords")
        lin = torch.where(mask, (c[..., 0] * H + c[..., 1]) * W + c[..., 2],
                          torch.full_like(c[..., 0], D * H * W))
        vol = vol.scatter(1, lin[..., None].expand(-1, -1, x.shape[-1]),
                          x * mask[..., None])
        return vol[:, :-1].reshape(B, D, H, W, -1), grid


# -- dense backbone and neck -------------------------------------------------

class BN3d(nn.BatchNorm3d):
    def __init__(self, c):
        super().__init__(c, eps=1e-3, momentum=0.01)

    def forward(self, x):
        if self.training:
            dims = (0, 2, 3, 4)
            mean = x.mean(dims, keepdim=True)
            var = ((x - mean) ** 2).mean(dims, keepdim=True)
            _track(self, mean.flatten(), var.flatten())
        else:
            mean = self.running_mean.view(1, -1, 1, 1, 1)
            var = self.running_var.view(1, -1, 1, 1, 1)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.weight.view(1, -1, 1, 1, 1)
                + self.bias.view(1, -1, 1, 1, 1))


def _cbr(cin, cout, k, stride=1, pad=0):
    return [nn.Conv3d(cin, cout, k, stride=stride, padding=pad, bias=False),
            BN3d(cout), nn.ReLU()]


def _conv(conv, x, quant):
    w = quant.dense(conv.weight)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, None, conv.stride, conv.padding)
    return F.conv3d(x, w, None, conv.stride, conv.padding)


def _run(seq, x, quant):
    mods = list(seq)
    for j in range(0, len(mods), 3):
        x = quant(torch.relu(mods[j + 1](_conv(mods[j], x, quant))))
    return x


class SECOND3D(nn.Module):
    def __init__(self, cin, chans, layers, strides):
        super().__init__()
        blocks = []
        for cout, n, s in zip(chans, layers, strides):
            mods = _cbr(cin, cout, (1, 3, 3), (1, s, s), (0, 1, 1))
            for _ in range(n):
                mods += _cbr(cout, cout, (1, 3, 3), 1, (0, 1, 1))
            blocks.append(nn.Sequential(*mods))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, quant):
        return [_run(b, x, quant) for b in self.blocks]


class SECOND3DFPN(nn.Module):
    def __init__(self, cins, couts, ups):
        super().__init__()
        de = []
        for cin, cout, s in zip(cins, couts, ups):
            up = (nn.ConvTranspose3d(cin, cout, (1, s, s), stride=(1, s, s),
                                     bias=False) if s > 1
                  else nn.Conv3d(cin, cout, 1, bias=False))
            de.append(nn.Sequential(up, BN3d(cout), nn.ReLU()))
        self.deblocks = nn.ModuleList(de)
        extra = []
        for _ in range(3):
            extra += _cbr(couts[-1], couts[-1], 3, 1, 1)
        self.extra_blocks = nn.Sequential(*extra)

    def forward(self, feats, quant):
        out = sum(_run(b, x, quant) for b, x in zip(self.deblocks, feats))
        return _run(self.extra_blocks, out, quant)


# -- FPS, sampling, decoder, head ---------------------------------------------

@torch.no_grad()
def fps(xyz, mask, S):
    """D-FPS of one set (N, 3): start at 0, masked points never chosen,
    ties to the lowest index, duplicates once the valid points run out."""
    mind = torch.where(mask, torch.full_like(xyz[:, 0], 1e10),
                       torch.full_like(xyz[:, 0], -1.0))
    idx = torch.zeros(S, dtype=torch.long, device=xyz.device)
    last = torch.zeros((), dtype=torch.long, device=xyz.device)
    for i in range(1, S):
        d = xyz - xyz[last]
        d = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
        mind = torch.where(mask, torch.minimum(mind, d), mind)
        last = torch.argmax(mind)
        idx[i] = last
    return idx


def grid_sample_3d(volume, coords, quant):
    """Trilinear sampling (align_corners=False, zeros outside) of (B, D,
    H, W, C) at (B, N, 3) (x, y, z) in [-1, 1]."""
    B, D, H, W, C = volume.shape
    pts = quant(coords)
    un = lambda g, n: ((g + 1.0) * n - 1.0) * 0.5
    x, y, z = un(pts[..., 0], W), un(pts[..., 1], H), un(pts[..., 2], D)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    flat = volume.reshape(B, D * H * W, C)
    out = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                      & (zi >= 0) & (zi < D))
                lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                       + xi.clamp(0, W - 1))
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz)) * ok.to(volume.dtype)
                out = out + torch.gather(
                    flat, 1, lin[..., None].expand(-1, -1, C)) * w[..., None]
    return out


def sine_embed(pos, nf=128, t=10000.0):
    dim_t = torch.arange(nf, dtype=torch.float32, device=pos.device)
    dim_t = t ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / nf)
    x = pos[..., None] * (2 * math.pi) / dim_t
    out = torch.stack([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])],
                      -1).reshape(*x.shape[:-1], nf)
    return out.reshape(*pos.shape[:-1], pos.shape[-1] * nf)


class MLP(nn.Module):
    def __init__(self, i, h, o, n):
        super().__init__()
        dims = [i] + [h] * (n - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in
                                    zip(dims, dims[1:] + [o]))

    def forward(self, x):
        for k, l in enumerate(self.layers):
            x = l(x)
            if k < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def branch(dim, out, ln):
    mods = []
    for _ in range(2):
        mods.append(nn.Linear(dim, dim))
        if ln:
            mods.append(nn.LayerNorm(dim, eps=1e-5))
        mods.append(nn.ReLU())
    mods.append(nn.Linear(dim, out))
    return nn.Sequential(*mods)


class SelfAttn(nn.Module):
    def __init__(self, c, heads, p):
        super().__init__()
        self.attn = nn.MultiheadAttention(c, heads, dropout=p,
                                          batch_first=True)

    def forward(self, q, v):
        return self.attn(q, q, v, need_weights=False)[0]


class CrossAttn(nn.Module):
    def __init__(self, c, p):
        super().__init__()
        self.dropout = p
        self.attention_weights = nn.Linear(c, 1)
        self.output_proj = nn.Linear(c, c)
        self.position_encoder = nn.Sequential(
            nn.Linear(3, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU(),
            nn.Linear(c, c), nn.LayerNorm(c, eps=1e-5), nn.ReLU())

    def forward(self, x, qpos, volume, ref, quant):
        B, G, nq, C = x.shape
        attw = torch.sigmoid(self.attention_weights(x + qpos))
        grid = torch.sigmoid(ref) * 2.0 - 1.0
        s = grid_sample_3d(volume, grid.reshape(B, G * nq, 3), quant)
        out = F.dropout(self.output_proj(s.reshape(B, G, nq, C) * attw),
                        self.dropout, self.training)
        return out + x + self.position_encoder(ref)


class FFN(nn.Module):
    def __init__(self, c, f, p):
        super().__init__()
        self.dropout = p
        self.layers = nn.Sequential(nn.Sequential(nn.Linear(c, f), nn.ReLU()),
                                    nn.Linear(f, c))

    def forward(self, x):
        y = F.dropout(self.layers[0](x), self.dropout, self.training)
        return F.dropout(self.layers[1](y), self.dropout, self.training)


class Layer(nn.Module):
    def __init__(self, c, heads, f, p):
        super().__init__()
        self.dropout = p
        self.attentions = nn.ModuleList([SelfAttn(c, heads, p),
                                         CrossAttn(c, p)])
        self.ffns = nn.ModuleList([FFN(c, f, p)])
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=1e-5)
                                   for _ in range(3))

    def forward(self, x, qpos, volume, ref, quant):
        B, G, nq, C = x.shape
        a = self.attentions[0]((x + qpos).reshape(B * G, nq, C),
                               x.reshape(B * G, nq, C))
        a = F.dropout(a, self.dropout, self.training)
        x = self.norms[0](x + a.reshape(B, G, nq, C))
        x = self.norms[1](self.attentions[1](x, qpos, volume, ref, quant))
        return self.norms[2](x + self.ffns[0](x))


class Decoder(nn.Module):
    def __init__(self, L, c, heads, f, p):
        super().__init__()
        self.ref_point_head = MLP(3 * 128, c, c, 3)
        self.query_scale = MLP(c, c, c, 3)
        self.layers = nn.ModuleList(Layer(c, heads, f, p) for _ in range(L))


class Transformer(nn.Module):
    def __init__(self, dec):
        super().__init__()
        self.decoder = dec


class Head(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        nq, C, L = cfg["num_query"], cfg["embed_dim"], \
            cfg["num_decoder_layers"]
        self.nq = nq
        self.pc_range = tuple(cfg["pc_range"])
        self.tgt_embed = nn.Embedding(2 * nq, C)
        self.refpoint_embed = nn.Embedding(nq, 3)
        self.cls_branches = nn.ModuleList(
            branch(C, cfg["num_classes"], True) for _ in range(L))
        self.reg_branches = nn.ModuleList(
            branch(C, cfg["code_size"], False) for _ in range(L))
        self.iou_branches = nn.ModuleList(
            branch(C, 1, False) for _ in range(L))
        self.transformer = Transformer(Decoder(
            L, C, cfg["num_heads"], cfg["ffn_dim"], cfg["dropout"]))

    def forward(self, volume, fpsbpts, random_points, quant):
        B, nq = fpsbpts.shape[0], self.nq
        tgt = self.tgt_embed.weight
        C = tgt.shape[1]
        shared = tgt[nq:].expand(B, 1, nq, C)
        contents = [tgt[:nq].expand(B, 1, nq, C), shared, shared]
        refs = [self.refpoint_embed.weight.expand(B, 1, nq, 3),
                inverse_sigmoid(fpsbpts).reshape(B, 2, nq, 3)]
        if not self.training:
            contents.append(shared)
            refs.append(inverse_sigmoid(random_points)[:, None])
        x = torch.cat(contents, 1)
        ref = torch.cat(refs, 1)
        G = x.shape[1]
        dec = self.transformer.decoder
        pr = self.pc_range
        cls, box, iou = [], [], []
        for l, layer in enumerate(dec.layers):
            raw = dec.ref_point_head(sine_embed(torch.sigmoid(ref)))
            qpos = raw if l == 0 else dec.query_scale(x) * raw
            x = layer(x, qpos, volume, ref, quant)
            tmp = self.reg_branches[l](x)
            h = x.reshape(B, G * nq, C)
            t = tmp.reshape(B, G * nq, -1)
            r = ref.reshape(B, G * nq, 3)
            xy = torch.sigmoid(t[..., 0:2] + r[..., 0:2])
            z = torch.sigmoid(t[..., 4:5] + r[..., 2:3])
            box.append(torch.cat([xy[..., 0:1] * (pr[3] - pr[0]) + pr[0],
                                  xy[..., 1:2] * (pr[4] - pr[1]) + pr[1],
                                  t[..., 2:4], z * (pr[5] - pr[2]) + pr[2],
                                  t[..., 5:]], -1))
            cls.append(self.cls_branches[l](h))
            iou.append(self.iou_branches[l](h)[..., 0])
            ref = torch.cat([tmp[..., 0:2] + ref[..., 0:2],
                             tmp[..., 4:5] + ref[..., 2:3]], -1).detach()
        return {"all_cls_scores": torch.stack(cls),
                "all_bbox_preds": torch.stack(box),
                "all_iou_preds": torch.stack(iou)}


def _minmax(p):
    mn, mx = p.amin(1, keepdim=True), p.amax(1, keepdim=True)
    return (p - mn) / (mx - mn).clamp(min=1e-6)


class Detector(nn.Module):
    """Points -> the head's per-layer stacks. ``cfg``: the configuration
    file's ``model`` dict."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.pts_middle_encoder = SparseEncoder(cfg)
        self.pts_backbone = SECOND3D(cfg["encoder_out_channels"],
                                     cfg["backbone_channels"],
                                     cfg["backbone_layers"],
                                     cfg["backbone_strides"])
        self.pts_neck = SECOND3DFPN(cfg["backbone_channels"],
                                    cfg["neck_channels"],
                                    cfg["neck_upsample_strides"])
        self.pts_bbox_head = Head(cfg)

    @torch.no_grad()
    def prepare(self, points):
        """Voxels, site sets and FPS seeds of a batch (B, P, C), every
        point valid."""
        cfg = self.cfg
        V = cfg["max_voxels"] if self.training else cfg["max_voxels_test"]
        nq = cfg["num_query"]
        feats, sets, seeds = [], [], []
        for pts in points:
            f, c, m = voxelize(pts, cfg, V)
            feats.append(f)
            sets.append(site_sets(cfg, c, m))
            xyz = pts[:, :3].float()
            vc = torch.where(m[:, None], c.flip(-1).float(),
                             torch.zeros_like(c, dtype=torch.float32))
            i1 = fps(xyz, torch.ones_like(xyz[:, 0], dtype=torch.bool), nq)
            i2 = fps(vc, m, nq)
            seeds.append(torch.cat([_minmax(xyz[i1][None]),
                                    _minmax(vc[i2][None])], 1)[0])
        return torch.stack(feats), sets, torch.stack(seeds)

    def dense(self, volume, fpsbpts, random_points, quant):
        """From the encoder's volume (B, D, H, W, C) on: SECOND3D, the FPN
        and the head."""
        x = quant(volume).permute(0, 4, 1, 2, 3)
        fused = quant(self.pts_neck(self.pts_backbone(x, quant), quant))
        fused = fused.permute(0, 2, 3, 4, 1)
        return self.pts_bbox_head(fused, fpsbpts, random_points, quant)

    def forward(self, points, random_points=None,
                quant=Precision(_identity, _identity)):
        feats, sets, seeds = self.prepare(points)
        volume, _ = self.pts_middle_encoder(feats, sets, quant)
        return self.dense(volume, seeds, random_points, quant)
