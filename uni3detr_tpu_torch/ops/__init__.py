"""Voxelizer, site sets, the CUDA kernels with their plain versions,
volume sampling and NMS of the port."""


def kernel_wrappers():
    """Every kernel wrapper of the model paths by the name ``chip_smoke.py``
    reports, each with its ``launches`` count (one a kernel launch on
    the card): K1-K4 and N1/N2 in inference, K1-K4 and K7/K10/K12 in
    training; N1 as the NMS bitmask, its BEV bitmask (TTA), its matrix
    (box merging and soft-NMS) and its two-set 3D and BEV forms (the
    metrics); N3 and N1's class blocks (the IoU of same-class pairs that
    N3 reads) in the coder's ``soft_nms`` post-processing; N4, the volume
    sampler, once a decoder layer (and an OV feature level's depth
    volume) in every forward, its backward as often in training."""
    from ..geom import iou
    from . import fps, matching, nms, sample, sparse_conv_cuda as sc
    return {"match_positions": sc.match_positions,
            "gather_conv": sc.gather_conv,
            "gather_conv_ids": sc.gather_conv_ids,
            "fps_pair": fps.farthest_point_sample_pair,
            "iou3d_rotated": nms.overlap_mask,
            "iou_bev_rotated_mask": nms.overlap_mask_bev,
            "nms_greedy": nms.greedy_scan,
            "soft_nms": nms.soft_nms_segments,
            "iou3d_rotated_blocks": nms.iou3d_class_blocks,
            "iou3d_rotated_matrix": iou.iou3d_rotated_pairwise,
            "iou3d_rotated_sets": iou.iou3d_rotated_sets,
            "iou_bev_rotated_sets": iou.iou_bev_rotated_sets,
            "gather_conv_dw": sc.gather_conv_dw,
            "gather_conv_ids_dw": sc.gather_conv_ids_dw,
            "auction_lap": matching.auction_lap,
            "grid_sample_3d": sample.grid_sample_3d,
            "grid_sample_3d_backward": sample.grid_sample_3d_backward}


def launch_counts():
    """``kernel_wrappers()``'s launch counts now, by name."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}
