"""The plain reference of OV-Uni3DETR, multimodal (fp32, plain PyTorch).

The point branch is the Lidar reference's (``model.py``: voxels, sparse
encoder, SECOND3D + FPN, FPS seeds). Added here, after OV-Uni3DETR
(zhenyuw16/Uni3DETR, ``ov_uni3detr_sunrgbd_mm.py``) and mmdet / mmcv:

- the image branch: mmdet's ResNet-50 (pytorch style, the stride on the
  3x3 conv) with mmcv's ``ModulatedDeformConv2d`` (DCNv2) as the 3x3 conv
  of the stages in ``stage_with_dcn``: ``conv_offset`` gives 2 k^2
  offsets, (dy, dx) a tap, and k^2 masks through a sigmoid; tap (i, j)
  of output (y, x) reads the input bilinearly at (y s + i - 1 + dy, x s +
  j - 1 + dx), zero outside, times its mask;
- mmdet's FPN (1x1 laterals, a top-down nearest upsample-add, 3x3
  outputs, a stride-2 subsample past the fourth level), the upsample
  with JAX's half-pixel rule (output pixel o reads input floor((o +
  0.5) in / out)); a 1x1 ``input_proj`` and a 1x1 ``depth_net`` with a
  softmax over the depth bins on each level;
- the lift: the encoder grid's voxel centres, pulled back through the
  inverse of ``uni_rot_aug``, projected through ``lidar2img``, kept in
  front of the camera and inside the (u, v, depth bin) frustum; each
  level sampled bilinearly at (u, v), times its depth distribution
  sampled trilinearly at (u, v, depth), summed over levels and cameras;
- the view convs (Conv3d 3x3x3 with bias, BN, ReLU, ``num_view_convs``
  times), the concatenation [points, image] and ``conv_trans_head_1``
  (Conv3d 2C -> C with bias, BN, ReLU);
- the CLIP head: the Lidar head's decoder and reg / IoU branches, a cls
  branch of 2 x (Linear, LN, ReLU) to ``clip_dim`` times the class
  embeddings ``zs_weights`` (clip_dim, ncls), and an uncertainty branch
  (the LN branch, ncls + 1 outputs).

Where it follows the JAX package rather than mmcv: the BatchNorm of the
view convs and of ``conv_trans_head_1`` takes eps 1e-3 (the JAX
package's constant, as the point branch's; mmcv's BN3d takes 1e-5), and
the reference's BatchNorm inside the sweep fusion's 1x1 convs is folded
into their kernel (none is built here: one sweep). The image branch
computes in fp32 on the image rounded to the configuration's dtype, with
the stem's output rounded to it again before the max-pool, as the JAX
package's flax convs promote; the lifted volume, the point volume and the
fused volume are rounded to it.

Module and parameter names are the port's, so one drawn ``state_dict``
loads on both sides. Inference only (eval-mode BatchNorm, four query
groups). Nothing here is fast: every DCN tap and every lift sample is a
gather.

``quant`` is ``model.Precision`` as there; ``dense`` rounds the weights
of every conv that the system under test runs in fp32 on TF32 (the
ResNet with its DCNs, the FPN, ``input_proj``, ``depth_net``, the view
convs and the fusion, besides the point branch's). An :class:`OVPrecision`
may also plant a fault in the reference (``FAULTS``), to show that the
comparison sees the image path: ``pairing_ri1`` fuses [points, points]
(the modality draw ri = 1's pairing) in place of [points, image], and
``dcn_offsets_zero`` runs every DCN with zero offsets (its masks kept).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .geometry import inverse_sigmoid
from .model import (BN3d, SECOND3D, SECOND3DFPN, Decoder, Detector, Precision,
                    SparseEncoder, Transformer, branch, grid_sample_3d,
                    quantizer as _base_quantizer, sine_embed)

STAGE_BLOCKS = (3, 4, 6, 3)        # ResNet-50
DEPTH_EPS = 1e-5
FAULTS = ("pairing_ri1", "dcn_offsets_zero")


class OVPrecision(Precision):
    """``model.Precision`` with a planted ``fault`` (one of ``FAULTS``, or
    None)."""

    def __init__(self, act, dense, fault=None):
        super().__init__(act, dense)
        self.fault = fault


def quantizer(precision: str) -> OVPrecision:
    """``model.quantizer``'s precisions (``float32``, ``bfloat16``,
    ``float8``, ``float8_alone``), the new layers covered like the rest;
    or a name of ``FAULTS``: the fp32 reference with that fault."""
    if precision in FAULTS:
        base, fault = _base_quantizer("float32"), precision
    else:
        base, fault = _base_quantizer(precision), None
    return OVPrecision(base.act, base.dense, fault)


def _fault(quant):
    return getattr(quant, "fault", None)


def _conv2d(conv, x, quant):
    return F.conv2d(x, quant.dense(conv.weight), conv.bias, conv.stride,
                    conv.padding)


def _conv3d(conv, x, quant):
    return F.conv3d(x, quant.dense(conv.weight), conv.bias, conv.stride,
                    conv.padding)


# -- image branch --------------------------------------------------------------

class BN2d(nn.BatchNorm2d):
    """Eval-mode BatchNorm, eps 1e-5 (mmdet's ResNet)."""

    def __init__(self, c):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        s = (1, -1, 1, 1)
        return ((x - self.running_mean.view(s))
                * torch.rsqrt(self.running_var.view(s) + self.eps)
                * self.weight.view(s) + self.bias.view(s))


def bilinear(img, y, x):
    """img (B, H, W, C); y, x (B, ...) pixel positions (pixel centres at
    integers) -> (B, ..., C): bilinear, each corner outside the image
    weighing zero."""
    B, H, W, C = img.shape
    flat = img.reshape(B, H * W, C)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()
    out = 0
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            w = (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * ok
            lin = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1)
            v = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
            out = out + v.reshape(*y.shape, C) * w[..., None]
    return out


class DCNv2(nn.Module):
    """mmcv's ``ModulatedDeformConv2dPack``, bias-free, padding (k - 1) /
    2."""

    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.conv_offset = nn.Conv2d(cin, 3 * k * k, k, stride,
                                     padding=(k - 1) // 2)

    def offsets(self, x, quant):
        """-> (offsets (B, 2 k^2, Ho, Wo), (dy, dx) of each tap in turn;
        masks (B, k^2, Ho, Wo))."""
        o1, o2, m = torch.chunk(_conv2d(self.conv_offset, x, quant), 3, 1)
        return torch.cat([o1, o2], 1), torch.sigmoid(m)

    def forward(self, x, quant):
        B, C, H, W = x.shape
        k, s = self.k, self.stride
        off, mask = self.offsets(x, quant)
        if _fault(quant) == "dcn_offsets_zero":
            off = torch.zeros_like(off)
        Ho, Wo = off.shape[2:]
        kk = k * k
        off = off.reshape(B, kk, 2, Ho, Wo)
        tap = torch.arange(kk, device=x.device)
        ti = (tap // k).float()[:, None, None] - (k - 1) // 2
        tj = (tap % k).float()[:, None, None] - (k - 1) // 2
        oy = (torch.arange(Ho, device=x.device) * s).float()[:, None]
        ox = (torch.arange(Wo, device=x.device) * s).float()[None, :]
        py = oy + ti + off[:, :, 0]                       # (B, kk, Ho, Wo)
        px = ox + tj + off[:, :, 1]
        val = bilinear(x.permute(0, 2, 3, 1), py, px)     # (B, kk, Ho, Wo, C)
        val = val * mask[..., None]
        cols = val.permute(0, 2, 3, 4, 1).reshape(B, Ho, Wo, C * kk)
        w = quant.dense(self.weight).reshape(self.weight.shape[0], C * kk)
        return (cols @ w.t()).permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, dcn, down):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BN2d(planes)
        self.conv2 = DCNv2(planes, planes, 3, stride) if dcn else \
            nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BN2d(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BN2d(4 * planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, 4 * planes, 1, stride, bias=False),
            BN2d(4 * planes)) if down else None

    def forward(self, x, quant):
        y = torch.relu(self.bn1(_conv2d(self.conv1, x, quant)))
        y = self.conv2(y, quant) if isinstance(self.conv2, DCNv2) \
            else _conv2d(self.conv2, y, quant)
        y = torch.relu(self.bn2(y))
        y = self.bn3(_conv2d(self.conv3, y, quant))
        if self.downsample is not None:
            x = self.downsample[1](_conv2d(self.downsample[0], x, quant))
        return torch.relu(y + x)


class ResNet50(nn.Module):
    def __init__(self, stage_with_dcn):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BN2d(64)
        cin = 64
        for i, n in enumerate(STAGE_BLOCKS):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(Bottleneck(cin, planes,
                                         2 if i > 0 and j == 0 else 1,
                                         stage_with_dcn[i], j == 0))
                cin = 4 * planes
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))

    def forward(self, x, quant):
        """x (B, 3, H, W), rounded to the configuration's dtype -> the four
        stage outputs."""
        x = quant(torch.relu(self.bn1(_conv2d(self.conv1, x, quant))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for i in range(len(STAGE_BLOCKS)):
            for blk in getattr(self, f"layer{i + 1}"):
                x = blk(x, quant)
            outs.append(x)
        return outs


class _ConvModule(nn.Module):
    """mmcv's ConvModule without a norm: the conv under ``.conv``."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=(k - 1) // 2)


def upsample_nearest(x, size):
    """(B, C, h, w) -> (B, C, *size), output pixel o reading input
    floor((o + 0.5) in / out) (fp32)."""
    for axis, n in ((2, size[0]), (3, size[1])):
        m = x.shape[axis]
        src = torch.floor((torch.arange(n, device=x.device).float() + 0.5)
                          * m / n).long()
        x = torch.index_select(x, axis, src)
    return x


class FPN2d(nn.Module):
    def __init__(self, cins=(256, 512, 1024, 2048), cout=256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(_ConvModule(c, cout, 1)
                                           for c in cins)
        self.fpn_convs = nn.ModuleList(_ConvModule(cout, cout, 3)
                                       for _ in cins)

    def forward(self, feats, levels, quant):
        lat = [_conv2d(m.conv, f, quant)
               for m, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + upsample_nearest(lat[i],
                                                       lat[i - 1].shape[2:])
        outs = [_conv2d(self.fpn_convs[i].conv, lat[i], quant)
                for i in range(min(levels, len(lat)))]
        while len(outs) < levels:
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs


# -- lift and view convs ---------------------------------------------------------

def voxel_centres(grid, pc_range, device=None):
    """(X Y Z, 3) centres of the (D, H, W) grid, x-major: i / (n - 1) on
    each axis (X = W, Y = H, Z = D) scaled to ``pc_range``."""
    D, H, W = grid
    axes = [torch.arange(n, device=device).float() / max(n - 1, 1)
            for n in (W, H, D)]
    c = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    lo = torch.tensor(pc_range[:3], device=device)
    hi = torch.tensor(pc_range[3:6], device=device)
    return c * (hi - lo) + lo


def project(centres, lidar2img, img_size, depth_dim):
    """centres (B, V, 3) world; lidar2img (B, N, 4, 4) -> ((u, v) (B, N,
    V, 2) in pixels, depth (B, N, V), in-frustum mask (B, N, V))."""
    hom = torch.cat([centres, torch.ones_like(centres[..., :1])], -1)
    cam = hom[:, None] @ lidar2img.transpose(-1, -2)     # (B, N, V, 4)
    depth = cam[..., 2]
    uv = cam[..., :2] / depth.clamp(min=DEPTH_EPS)[..., None]
    H, W = img_size
    u = uv[..., 0] / W * 2 - 1
    v = uv[..., 1] / H * 2 - 1
    dz = depth / depth_dim * 2 - 1
    mask = (depth > DEPTH_EPS) & (u.abs() < 1) & (v.abs() < 1) & \
        (dz.abs() < 1)
    return uv, depth, mask


class ViewTrans(nn.Module):
    def __init__(self, C, n, k):
        super().__init__()
        pad = tuple((s - 1) // 2 for s in k)
        for i in range(n):
            self.add_module(f"conv_trans_head_{i + 1}", nn.Sequential(
                nn.Conv3d(C, C, tuple(k), padding=pad), BN3d(C), nn.ReLU()))
        self.n = n

    def forward(self, vol, quant):
        """(B, C, D, H, W) -> (B, C, D, H, W), fp32."""
        for i in range(self.n):
            conv, bn, _ = getattr(self, f"conv_trans_head_{i + 1}")
            vol = torch.relu(bn(_conv3d(conv, vol, quant)))
        return vol


# -- CLIP head -------------------------------------------------------------------

def clip_branch(dim, clip_dim):
    return nn.Sequential(nn.Linear(dim, clip_dim),
                         nn.LayerNorm(clip_dim, eps=1e-5), nn.ReLU(),
                         nn.Linear(clip_dim, clip_dim),
                         nn.LayerNorm(clip_dim, eps=1e-5), nn.ReLU())


class CLIPHead(nn.Module):
    """The Lidar head's decoder, four eval query groups, with the CLIP
    cls branch and the uncertainty branch."""

    def __init__(self, cfg):
        super().__init__()
        nq, C, L = cfg["num_query"], cfg["embed_dim"], \
            cfg["num_decoder_layers"]
        ncls = cfg["num_classes"]
        self.nq = nq
        self.pc_range = tuple(cfg["pc_range"])
        self.tgt_embed = nn.Embedding(2 * nq, C)
        self.refpoint_embed = nn.Embedding(nq, 3)
        self.cls_branches = nn.ModuleList(
            clip_branch(C, cfg["clip_dim"]) for _ in range(L))
        self.uncertainty_branches = nn.ModuleList(
            branch(C, ncls + 1, True) for _ in range(L))
        self.reg_branches = nn.ModuleList(
            branch(C, cfg["code_size"], False) for _ in range(L))
        self.iou_branches = nn.ModuleList(
            branch(C, 1, False) for _ in range(L))
        self.transformer = Transformer(Decoder(
            L, C, cfg["num_heads"], cfg["ffn_dim"], cfg["dropout"]))
        self.register_buffer("zs_weights", torch.zeros(cfg["clip_dim"],
                                                       ncls))

    def forward(self, volume, fpsbpts, random_points, quant):
        B, nq = fpsbpts.shape[0], self.nq
        tgt = self.tgt_embed.weight
        C = tgt.shape[1]
        shared = tgt[nq:].expand(B, 1, nq, C)
        x = torch.cat([tgt[:nq].expand(B, 1, nq, C), shared, shared, shared],
                      1)
        ref = torch.cat([self.refpoint_embed.weight.expand(B, 1, nq, 3),
                         inverse_sigmoid(fpsbpts).reshape(B, 2, nq, 3),
                         inverse_sigmoid(random_points)[:, None]], 1)
        G = x.shape[1]
        dec = self.transformer.decoder
        pr = self.pc_range
        outs = {k: [] for k in ("all_cls_scores", "all_bbox_preds",
                                "all_iou_preds", "all_uncertainty_preds")}
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
            outs["all_bbox_preds"].append(torch.cat(
                [xy[..., 0:1] * (pr[3] - pr[0]) + pr[0],
                 xy[..., 1:2] * (pr[4] - pr[1]) + pr[1], t[..., 2:4],
                 z * (pr[5] - pr[2]) + pr[2], t[..., 5:]], -1))
            outs["all_cls_scores"].append(self.cls_branches[l](h)
                                          @ self.zs_weights)
            outs["all_iou_preds"].append(self.iou_branches[l](h)[..., 0])
            outs["all_uncertainty_preds"].append(
                self.uncertainty_branches[l](h))
            ref = torch.cat([tmp[..., 0:2] + ref[..., 0:2],
                             tmp[..., 4:5] + ref[..., 2:3]], -1).detach()
        return {k: torch.stack(v) for k, v in outs.items()}


# -- the detector ----------------------------------------------------------------

def encoder_grid(cfg):
    grid = tuple(cfg["grid_size"])
    for pad in cfg["encoder_downsample_paddings"]:
        grid = tuple((g + 2 * p - 3) // 2 + 1 for g, p in zip(grid, pad))
    return grid


class OVDetector(Detector):
    """Points, one image a camera and its cameras -> the CLIP head's
    per-layer stacks. ``cfg``: the configuration file's ``model`` dict
    (``OVUni3DETRConfig``'s fields, one sweep, both branches)."""

    def __init__(self, cfg):
        nn.Module.__init__(self)
        self.cfg = cfg
        C = cfg["embed_dim"]
        self.pts_middle_encoder = SparseEncoder(cfg)
        self.pts_backbone = SECOND3D(cfg["encoder_out_channels"],
                                     cfg["backbone_channels"],
                                     cfg["backbone_layers"],
                                     cfg["backbone_strides"])
        self.pts_neck = SECOND3DFPN(cfg["backbone_channels"],
                                    cfg["neck_channels"],
                                    cfg["neck_upsample_strides"])
        self.img_backbone = ResNet50(cfg["stage_with_dcn"])
        self.img_neck = FPN2d(cout=C)
        self.input_proj = nn.Conv2d(C, C, 1)
        self.depth_net = nn.Conv2d(C, cfg["depth_dim"], 1)
        self.view_trans = ViewTrans(C, cfg["num_view_convs"],
                                    cfg["view_kernel"])
        self.conv_trans_head_1 = nn.Sequential(
            nn.Conv3d(2 * C, C, 3, padding=1), BN3d(C), nn.ReLU())
        self.pts_bbox_head = CLIPHead(cfg)

    def image_features(self, images, quant):
        """images (B, N, H, W, 3) -> (per level the projected features (B,
        N, Hl, Wl, C), per level the depth distributions (B, N, Hl, Wl,
        depth_dim)), fp32; and the ResNet's four stage outputs."""
        B, N, H, W, _ = images.shape
        x = quant(images.reshape(B * N, H, W, 3).permute(0, 3, 1, 2))
        stages = self.img_backbone(x, quant)
        mlvl, depths = [], []
        for f in self.img_neck(stages, self.cfg["fpn_levels"], quant):
            p = _conv2d(self.input_proj, f, quant)
            d = torch.softmax(_conv2d(self.depth_net, p, quant), 1)
            for out, t in ((mlvl, p), (depths, d)):
                t = t.permute(0, 2, 3, 1)
                out.append(t.reshape(B, N, *t.shape[1:]))
        return mlvl, depths, stages

    def lift(self, mlvl, depths, lidar2img, uni_rot_aug):
        """-> (the lifted (B, N, V, C) voxel features, zero outside the
        frustum; the frustum mask (B, N, V))."""
        B, N = lidar2img.shape[:2]
        grid = encoder_grid(self.cfg)
        ctr = voxel_centres(grid, self.cfg["pc_range"], lidar2img.device)
        ctr = ctr[None] @ torch.linalg.inv(uni_rot_aug.float())
        H, W = self.cfg["img_size"]
        uv, depth, mask = project(ctr, lidar2img, (H, W),
                                  self.cfg["depth_dim"])
        exact = quantizer("float32")       # the lift computes in fp32
        out = 0
        for f, d in zip(mlvl, depths + depths[-1:] * len(mlvl)):
            Hl, Wl = f.shape[2:4]
            f = f.reshape(B * N, Hl, Wl, -1)
            # pixel positions on this level (align_corners=False)
            y = (uv[..., 1] * Hl / H - 0.5).reshape(B * N, -1)
            x = (uv[..., 0] * Wl / W - 0.5).reshape(B * N, -1)
            feat = bilinear(f, y, x)
            dvol = d.reshape(B * N, Hl, Wl, -1).permute(0, 3, 1, 2)[..., None]
            g = torch.stack([uv[..., 0] / W * 2 - 1, uv[..., 1] / H * 2 - 1,
                             depth / self.cfg["depth_dim"] * 2 - 1], -1)
            w = grid_sample_3d(dvol, g.reshape(B * N, -1, 3), exact)
            out = out + feat * w
        out = out.reshape(B, N, -1, out.shape[-1])
        return out * mask[..., None], mask

    def image_volume(self, lifted, quant):
        """The lifted features summed over the cameras -> the view convs'
        volume (B, D, H, W, C) fp32."""
        D, H, W = encoder_grid(self.cfg)
        B = lifted.shape[0]
        vol = lifted.sum(1).reshape(B, W, H, D, -1).permute(0, 4, 3, 2, 1)
        return self.view_trans(vol, quant).permute(0, 2, 3, 4, 1)

    def fuse(self, pts, img, quant):
        """[points, image] (both (B, D, H, W, C), rounded) ->
        ``conv_trans_head_1``'s volume, rounded."""
        pair = (pts, pts) if _fault(quant) == "pairing_ri1" else (pts, img)
        x = torch.cat(pair, -1).permute(0, 4, 1, 2, 3)
        conv, bn, _ = self.conv_trans_head_1
        return quant(torch.relu(bn(_conv3d(conv, x, quant)))).permute(
            0, 2, 3, 4, 1)

    def forward(self, batch, quant=quantizer("float32"), inter=None):
        """batch: points (B, P, C), random_points (B, nq, 3), images (B, N,
        H, W, 3), lidar2img (B, N, 4, 4), uni_rot_aug (B, 3, 3). ``inter``,
        a dict, receives the intermediates."""
        feats, sets, seeds = self.prepare(batch["points"])
        volume, _ = self.pts_middle_encoder(feats, sets, quant)
        return self.dense(volume, seeds, batch["random_points"],
                          batch["images"], batch["lidar2img"],
                          batch["uni_rot_aug"], quant, inter)

    def dense(self, volume, fpsbpts, random_points, images, lidar2img,
              uni_rot_aug, quant, inter=None):
        """From the encoder's volume (B, D, H, W, C) and the images on:
        SECOND3D, the FPN, the image branch, the lift, the view convs, the
        fusion and the head (what ``FlopCounterMode`` counts)."""
        x = quant(volume).permute(0, 4, 1, 2, 3)
        pts = quant(self.pts_neck(self.pts_backbone(x, quant), quant))
        pts = pts.permute(0, 2, 3, 4, 1)
        mlvl, depths, _ = self.image_features(images, quant)
        lifted, mask = self.lift(mlvl, depths, lidar2img, uni_rot_aug)
        img = quant(self.image_volume(lifted, quant))
        fused = self.fuse(pts, img, quant)
        if inter is not None:
            inter.update(mlvl=mlvl, depths=depths, lifted=lifted, mask=mask,
                         image_volume=img, point_volume=pts,
                         fused_volume=fused)
        return self.pts_bbox_head(fused, fpsbpts, random_points, quant)
