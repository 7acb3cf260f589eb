"""Trilinear and bilinear sampling (port of ``uni3detr_tpu/ops/sample.py``).

``F.grid_sample`` semantics with align_corners=False and zero padding,
written as eight (or four) corner gathers on a channels-last volume (or
image), the JAX package's layout. As there, the sample coordinates are
first cast to the input's dtype (bf16 under the bf16 presets), and the
weights and the sum are computed in that dtype.

:func:`grid_sample_3d` (N4, replaces XLA's ``grid_sample_3d``, not a
Pallas kernel) samples a CUDA volume with one launch of the kernel in
``csrc/sample.cu``, bit-equal to :func:`grid_sample_3d_plain`, and
differentiates through :func:`grid_sample_3d_backward` (one more launch,
plus the zero-fills of its gradients; CUDA tensors only); CPU tensors
take the plain version and its autograd. Each of the two wrappers counts
its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from . import cost, cuda_lib
from ..utils.profiling import count


def _unnormalize(g, size):
    return ((g + 1.0) * size - 1.0) * 0.5


def _corners(coords, dtype, D, H, W):
    """The sampler's corners of each point (B, N): ``(f, corners)`` with
    ``f`` the fractions (fx, fy, fz) in ``dtype``, and ``corners`` eight
    ``((dx, dy, dz), row, weight, ok)`` in the order (dz, dy, dx): the
    corner's row of the (D * H * W) flattened volume (clamped into it),
    its weight in ``dtype`` (0 outside) and whether it lies inside."""
    pts = coords.to(dtype)
    x = _unnormalize(pts[..., 0], W)
    y = _unnormalize(pts[..., 1], H)
    z = _unnormalize(pts[..., 2], D)
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi, zi = x0 + dx, y0 + dy, z0 + dz
                ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                      & (zi >= 0) & (zi < D))
                lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                       + xi.clamp(0, W - 1))
                wx = fx if dx == 1 else 1.0 - fx
                wy = fy if dy == 1 else 1.0 - fy
                wz = fz if dz == 1 else 1.0 - fz
                w = (wx * wy * wz) * ok.to(dtype)
                out.append(((dx, dy, dz), lin, w, ok))
    return (fx, fy, fz), out


def grid_sample_3d_plain(volume: torch.Tensor, coords: torch.Tensor
                         ) -> torch.Tensor:
    """volume (B, D, H, W, C); coords (B, N, 3) in [-1, 1] ordered
    (x, y, z) -> (B, N, C)."""
    B, D, H, W, C = volume.shape
    flat = volume.reshape(B, D * H * W, C)
    out = None
    for _, lin, w, _ in _corners(coords, volume.dtype, D, H, W)[1]:
        val = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
        c = val * w[..., None]
        out = c if out is None else out + c
    return out


def grid_sample_3d_backward_plain(volume: torch.Tensor, coords: torch.Tensor,
                                  grad: torch.Tensor, volume_grad=True,
                                  coords_grad=False):
    """The gradients of ``sum(grad * grid_sample_3d_plain(volume,
    coords))``: ``(d volume or None, d coords or None)``, as the kernel
    computes them. The volume's: each corner's ``grad * w`` (in the
    volume's dtype) summed into one zeroed volume of that dtype. The
    coordinates': in fp32, from each corner's ``dot(grad, row) * ok``
    and the weights' factors, times size / 2 per axis, then cast to the
    coordinates' dtype."""
    B, D, H, W, C = volume.shape
    f, corners = _corners(coords, volume.dtype, D, H, W)
    gv = gc = None
    if volume_grad:
        g = grad.to(volume.dtype)
        gv = volume.new_zeros((B, D * H * W, C))
        for _, lin, w, _ in corners:
            gv.scatter_add_(1, lin[..., None].expand(-1, -1, C),
                            g * w[..., None])
        gv = gv.reshape(volume.shape)
    if coords_grad:
        flat = volume.reshape(B, D * H * W, C)
        g = grad.float()
        u = [(1.0 - a).float() for a in f]      # rounded as the weights'
        f = [a.float() for a in f]
        dc = [torch.zeros(coords.shape[:2], device=coords.device)
              for _ in range(3)]
        for d, lin, _, ok in corners:
            row = torch.gather(flat, 1, lin[..., None].expand(-1, -1, C))
            gw = (g * row.float()).sum(-1) * ok.float()
            wa = [f[a] if d[a] else u[a] for a in range(3)]
            for a in range(3):
                other = wa[(a + 1) % 3] * wa[(a + 2) % 3]
                dc[a] = dc[a] + (gw if d[a] else -gw) * other
        gc = torch.stack([dc[0] * (0.5 * W), dc[1] * (0.5 * H),
                          dc[2] * (0.5 * D)], -1).to(coords.dtype)
    return gv, gc


_VOLUME_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the decoder's reference points (fp32 or the preset's bf16) and the OV
# lift's camera grid (fp32): cast to fp32 exactly, so the kernel's cast
# to the volume's dtype is the plain version's
_COORD_DTYPES = (torch.float32, torch.bfloat16)


def _on_cpu(name, volume, coords, *more) -> bool:
    """Validate the arguments; True when all lie on the CPU (the plain
    path), False when all lie on one CUDA device (the kernel)."""
    if not (volume.dim() == 5 and coords.dim() == 3
            and coords.shape[-1] == 3 and coords.shape[0] == volume.shape[0]):
        raise ValueError(f"{name}: volume (B, D, H, W, C), coords (B, N, 3)")
    tensors = (volume, coords, *more)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if not all(t.is_cuda and t.device == volume.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if volume.dtype not in _VOLUME_DTYPES:
        raise ValueError(f"{name}: the kernel takes an fp32 or bf16 volume, "
                         f"not {volume.dtype}")
    if coords.dtype not in _COORD_DTYPES:
        raise ValueError(f"{name}: coords must be fp32 or bf16, not "
                         f"{coords.dtype}")
    return False


def _launch(name, volume, coords, *tensors):
    """Call the C function ``name`` on the volume (contiguous), the fp32
    coordinates (contiguous) and the further pointers ``tensors`` (None
    for a null pointer); 16-byte chunks where every pointer and a row of
    C channels allow them."""
    B, D, H, W, C = volume.shape
    ptrs = [t.data_ptr() if t is not None else None
            for t in (volume, coords, *tensors)]
    vec = (C * volume.element_size()) % 16 == 0 and all(
        p % 16 == 0 for p, t in zip(ptrs, (volume, coords, *tensors))
        if t is not None and t is not coords)
    with torch.cuda.device(volume.device):
        status = getattr(cuda_lib.library(), name)(
            *ptrs, B, coords.shape[1], D, H, W, C,
            _VOLUME_DTYPES[volume.dtype], int(vec),
            torch.cuda.current_stream(volume.device).cuda_stream)
    cuda_lib.check(status, name)


def _sample(volume, coords):
    """The forward kernel on a contiguous volume and fp32 coordinates."""
    B, N = coords.shape[:2]
    out = torch.empty((B, N, volume.shape[-1]), dtype=volume.dtype,
                      device=volume.device)
    if out.numel():
        _launch("u3d_grid_sample_3d", volume, coords, out)
        grid_sample_3d.launches += 1
        cost.record("grid_sample_3d", (volume, coords), out)
        count("grid_sample3d.kernel", 1)
        count("grid_sample3d.points", B * N)
    return out


class _Sample3d(torch.autograd.Function):

    @staticmethod
    def forward(ctx, volume, coords):
        ctx.save_for_backward(volume, coords)
        return _sample(volume, coords)

    @staticmethod
    def backward(ctx, grad):
        volume, coords = ctx.saved_tensors
        return grid_sample_3d_backward(volume, coords, grad,
                                       *ctx.needs_input_grad)


def grid_sample_3d(volume: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """N4: volume (B, D, H, W, C); coords (B, N, 3) in [-1, 1] ordered
    (x, y, z) -> (B, N, C) in the volume's dtype. See
    :func:`grid_sample_3d_plain`; on the card one kernel launch,
    differentiable in both arguments."""
    if _on_cpu("grid_sample_3d", volume, coords):
        return grid_sample_3d_plain(volume, coords)
    volume = volume.contiguous()
    coords = coords.float().contiguous()
    if torch.is_grad_enabled() and (volume.requires_grad
                                    or coords.requires_grad):
        return _Sample3d.apply(volume, coords)
    return _sample(volume, coords)


grid_sample_3d.launches = 0


def grid_sample_3d_backward(volume: torch.Tensor, coords: torch.Tensor,
                            grad: torch.Tensor, volume_grad=True,
                            coords_grad=False):
    """N4's backward: ``(d volume or None, d coords or None)`` of
    ``sum(grad * grid_sample_3d(volume, coords))``; see
    :func:`grid_sample_3d_backward_plain`. CUDA tensors only (CPU tensors
    differentiate through autograd of the plain forward): one kernel
    launch (none when neither gradient is asked for) after zero-filling
    the gradients; the volume's sums in its dtype with atomics, in no
    fixed order."""
    if _on_cpu("grid_sample_3d_backward", volume, coords, grad):
        raise ValueError("grid_sample_3d_backward: CUDA tensors only; the "
                         "plain version is grid_sample_3d_backward_plain")
    if not (volume_grad or coords_grad):
        return None, None
    B, N = coords.shape[:2]
    if tuple(grad.shape) != (B, N, volume.shape[-1]):
        raise ValueError("grid_sample_3d_backward: grad (B, N, C)")
    volume = volume.contiguous()
    dtype = coords.dtype
    coords = coords.float().contiguous()
    grad = grad.to(volume.dtype).contiguous()
    gv = torch.zeros_like(volume) if volume_grad else None
    gc = (torch.zeros((B, N, 3), dtype=torch.float32, device=coords.device)
          if coords_grad else None)
    if grad.numel():
        _launch("u3d_grid_sample_3d_backward", volume, coords, grad, gv, gc)
        grid_sample_3d_backward.launches += 1
        cost.record("grid_sample_3d_backward", (volume, coords, grad),
                    *(t for t in (gv, gc) if t is not None))
    return gv, gc.to(dtype) if gc is not None else None


grid_sample_3d_backward.launches = 0


def grid_sample_2d(image: torch.Tensor, coords: torch.Tensor
                   ) -> torch.Tensor:
    """image (..., H, W, C); coords (..., N, 2) in [-1, 1] ordered (x, y)
    -> (..., N, C). Corners outside the image weigh zero."""
    H, W, C = image.shape[-3:]
    batch = image.shape[:-3]
    img = image.reshape(-1, H * W, C)
    pts = coords.reshape(img.shape[0], -1, 2).to(image.dtype)
    x = _unnormalize(pts[..., 0], W)
    y = _unnormalize(pts[..., 1], H)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    # one row gather per corner over the flattened (batch, pixel) rows
    rows = img.reshape(-1, C)
    base = (torch.arange(img.shape[0], device=image.device) * (H * W))[:, None]
    out = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1) + base
            wx = fx if dx == 1 else 1.0 - fx
            wy = fy if dy == 1 else 1.0 - fy
            w = (wx * wy) * ok.to(image.dtype)
            c = rows[lin] * w[..., None]
            out = c if out is None else out + c
    return out.reshape(*batch, -1, C)
