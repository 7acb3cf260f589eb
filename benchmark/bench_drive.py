"""Set-up, the measured window and the check of one run of a cell.

One general runner, steered by the traffic mix's parameters, on the
model family that the configuration names (``families/``: the model,
its scenes, its weights, its inference call and its reference):

- ``kind: train``: ``train_step`` back to back on batches of ``batch``
  scenes cycled from a pool of ``pool_batches``; set-up drives the first
  ``checked_steps`` through the same call and feed (the steps the
  reference follows). The host reads each step's loss after queueing the
  next, as a training loop that logs its losses does.
- ``kind: infer``, ``loop: pipelined``: forward, decode and NMS on
  batches back to back, each batch's boxes copied to the host and waited
  for after the next batch is queued.
- ``kind: infer``, ``loop: closed``: one batch at a time, each timed from
  the hand-over of its points on the host to its kept boxes on the host.

Inputs sit in pinned host memory and are copied to the device inside the
window, as a loader hands them over.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch

import bench_check
import bench_trace
import bench_weights


def _pin(arrays, device):
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        out[k] = t.pin_memory() if device.type == "cuda" else t
    return out


def _to(host, device):
    return {k: v.to(device, non_blocking=True) for k, v in host.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Tracer:
    """The traced part of the window, after ``trace_skip`` iterations:
    ``trace_iters`` with the stage clock, ``trace_iters`` with the device
    profiled alone (kernels, busy share, launches), then ``HOST_ITERS``
    with host and device profiled (what the host did in each idle
    gap). ``stages``: the family's ``STAGE_MODULES``."""

    HOST_ITERS = 2

    def __init__(self, model, traffic, device, stages):
        self.skip = traffic["trace_skip"]
        self.n = traffic["trace_iters"]
        self.device = device
        self.clock = bench_trace.StageClock(model, device, stages)
        self.kernels = self.host = self.span = None
        self.traced = []       # pool indices of the profiled iterations

    def _profile(self, acts):
        prof = torch.profiler.profile(activities=acts, acc_events=True)
        prof.__enter__()
        return prof

    def before(self, i, pool_index):
        k = i - self.skip
        cuda = [torch.profiler.ProfilerActivity.CUDA] \
            if self.device.type == "cuda" else []
        if k == 0:
            self.clock.armed = True
        elif k == self.n:
            self.clock.armed = False
            self.kernels = self._profile(
                cuda or [torch.profiler.ProfilerActivity.CPU])
            _sync(self.device)
            self.t0 = time.perf_counter()
        elif k == 2 * self.n:
            self.host = self._profile(
                [torch.profiler.ProfilerActivity.CPU] + cuda)
            self.clock.spans = True
            self.span = torch.profiler.record_function(
                bench_trace.WINDOW_SPAN)
            self.span.__enter__()
        if self.n <= k < 2 * self.n:
            self.traced.append(pool_index)

    def after(self, i):
        k = i - self.skip
        if k == 2 * self.n - 1:
            _sync(self.device)
            self.window_s = time.perf_counter() - self.t0
            self.kernels.__exit__(None, None, None)
        elif k == 2 * self.n + self.HOST_ITERS - 1:
            _sync(self.device)
            self.span.__exit__(None, None, None)
            self.clock.spans = False
            self.host.__exit__(None, None, None)

    def active(self, i):
        """Whether the stage clock records this iteration."""
        return 0 <= i - self.skip < self.n

    def profiled(self, i):
        return self.n <= i - self.skip < 2 * self.n + self.HOST_ITERS

    def done(self, i):
        return i >= self.skip + 2 * self.n + self.HOST_ITERS

    def data(self, work, frames_s):
        self.clock.remove()
        return bench_trace.TraceData(self.kernels, self.host, self.clock,
                                     len(self.traced), self.window_s, work,
                                     frames_s)


def _device_info(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def _peak(device):
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


class Marks:
    """Host-clock marks of a run: the steps of its set-up (from the
    process's start) and, in the window, the end of each iteration;
    printed on standard error beside the result, never a metric."""

    def __init__(self, t_start):
        self.t = t_start
        self.setup = {}
        self.ends = []

    def step(self, name):
        now = time.perf_counter()
        self.setup[name] = now - self.t
        self.t = now

    def chunks(self, t0, per_iter, width=5.0):
        """The rate of each whole ``width``-second part of the window."""
        out, n, edge = [], 0, t0 + width
        for e in self.ends:
            while e > edge:
                out.append(n * per_iter / width)
                n, edge = 0, edge + width
            n += 1
        return out


# -- training -----------------------------------------------------------------

def run_train(cell, seed, seconds, trace, device, t_start, fault=None):
    """One run of a train cell. ``fault`` plants a fault in the timed
    path (tests and calibration only): ``"half_batch"`` drops the second
    half of every batch, ``"frozen"`` skips the optimizer's update."""
    from uni3detr_tpu_torch.train import step as tstep

    marks = Marks(t_start)
    marks.step("imports")
    fam = cell.family
    tr, m, tc = cell.traffic, cell.model, cell.config["train"]
    B, npool, nchk = tr["batch"], tr["pool_batches"], tr["checked_steps"]
    pool = [_pin(fam.train_batch(seed, m, B, i), device)
            for i in range(npool)]
    marks.step("scene_pool")
    model = fam.build(fam.port_config(m)).to(device)
    sd = bench_weights.draw(model, seed, tr["weights"], device,
                            fam.weight_rule)
    model.load_state_dict(sd)
    # the parameters the optimizer holds: a frozen stage's are left out
    params = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    init = {k: sd[k].to("cpu") for k, _ in params}
    bn0 = {k: v.to("cpu") for k, v in sd.items()
           if k.endswith(("running_mean", "running_var"))}
    del sd
    lr, beta1 = bench_check.schedules(tc)
    opt = tstep.make_optimizer(
        model, lr, tc["optimizer"]["weight_decay"],
        tc["optimizer"]["clip_norm"], momentum_schedule=beta1,
        **fam.optimizer_kwargs(cell.config))

    def step(batch):
        if fault == "half_batch":
            batch = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
        if fault == "frozen":
            saved = [p.detach().clone() for _, p in params]
            logs = tstep.train_step(model, opt, batch)
            with torch.no_grad():
                for (_, p), s in zip(params, saved):
                    p.copy_(s)
            return logs
        return tstep.train_step(model, opt, batch)

    prog = {"loss": []}
    for k in range(nchk):
        torch.manual_seed(bench_check.step_seed(seed, k))
        logs = step(_to(pool[k % npool], device))
        prog["loss"].append(logs["total_loss"])
        if k == 0:
            g = torch.stack([opt.adamw.state[p]["exp_avg"].double().norm()
                             for _, p in params]) / (1.0 - beta1(0))
            prog["grad"] = dict(zip([n for n, _ in params], g.tolist()))
            prog["bn"] = bench_check.bn_moves(model, bn0)
    prog["loss"] = [float(v) for v in prog["loss"]]
    prog["change"] = {n: float((p.detach() - init[n].to(device)).double()
                               .norm()) for n, p in params}
    del init
    marks.step("model_and_checked_steps")

    tracer = Tracer(model, tr, device, fam.STAGE_MODULES) if trace else None
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i, prev, failed = 0, None, 0
    while True:
        idx = (nchk + i) % npool
        if tracer:
            tracer.before(i, idx)
        logs = step(_to(pool[idx], device))
        if tracer and tracer.active(i):
            tracer.clock.mark("after_forward")
        if prev is not None:
            failed += not math.isfinite(prev.item())
        prev = logs["total_loss"]
        if tracer:
            tracer.after(i)
        i += 1
        marks.ends.append(time.perf_counter())
        if marks.ends[-1] - t0 >= seconds and (
                tracer is None or tracer.done(i)):
            break
    failed += not math.isfinite(prev.item())
    _sync(device)
    window = time.perf_counter() - t0
    peak = _peak(device)
    result = {"attempted": i, "failed": failed, "window_s": window,
              "setup_s": setup_s, "peak": peak,
              "train_scenes_per_s": B * i / window,
              "setup_steps": marks.setup, "chunk_rates": marks.chunks(t0, B)}
    if tracer:
        result["trace"] = tracer.data(
            fam.work(m, True, B, [(j, pool[j]) for j in tracer.traced]), [])
    del model, opt, params, logs, prev, tracer
    _free()
    ref = bench_check.train_reference(cell, seed, pool[:nchk], device)
    result["numbers"] = bench_check.train_numbers(prog, ref)
    result["readings"] = {"program": prog, "reference": ref}
    result["pool"] = pool
    return result


# -- inference ----------------------------------------------------------------

def run_infer(cell, seed, seconds, trace, device, t_start, fault=None):
    """One run of an inference cell. ``fault`` plants a fault in the
    timed path (tests and calibration only): ``"altered"`` moves the score
    of the first kept box of every batch by 0.5 where the program produces
    it, ``"half_empty"`` returns no box for the second half of every
    batch, ``"no_nms"`` skips the NMS (every candidate over the score and
    count cuts is kept)."""
    from uni3detr_tpu_torch.train.coder import decode_predictions, \
        post_process

    marks = Marks(t_start)
    marks.step("imports")
    fam, tr, m = cell.family, cell.traffic, cell.model
    B, npool = tr["batch"], tr["pool_batches"]
    pool = [_pin(fam.infer_batch(seed, m, B, i), device)
            for i in range(npool)]
    marks.step("scene_pool")
    cfg = fam.port_config(m)
    model = fam.build(cfg).to(device).eval()
    model.load_state_dict(bench_weights.draw(model, seed, tr["weights"],
                                             device, fam.weight_rule))
    marks.step("model")
    post_cfg = dataclasses.replace(cfg, post_processing="none") \
        if fault == "no_nms" else cfg

    @torch.no_grad()
    def detect(batch):
        outs = fam.infer(model, batch)
        res = post_process(*decode_predictions(outs, cfg), post_cfg)
        if fault == "half_empty":
            boxes, scores, labels, valid = res
            valid = valid.clone()
            valid[B // 2:] = False
            res = boxes, scores, labels, valid
        if fault == "altered":
            boxes, scores, labels, valid = res
            first = valid.int().argmax(1)
            scores = scores.clone()
            scores[torch.arange(B, device=scores.device), first] += 0.5
            res = boxes, scores, labels, valid
        return res

    pipelined = tr["loop"] == "pipelined"
    ring = []
    if pipelined:
        with torch.no_grad():
            shapes = [t.shape for t in detect(_to(pool[0], device))]
        dtypes = [torch.float32, torch.float32, torch.int32, torch.bool]
        for _ in range(2):
            ring.append([torch.empty(s, dtype=d,
                                     pin_memory=device.type == "cuda")
                         for s, d in zip(shapes, dtypes)])

    outputs = []       # (pool index, host arrays) of every batch

    def land(slot, idx):
        boxes, scores, labels, valid = (t.numpy().copy() for t in slot)
        outputs.append((idx, {"boxes": boxes, "scores": scores,
                              "labels": labels, "valid": valid}))
        return valid, boxes, scores

    for w in range(tr["warmup_batches"]):
        res = detect(_to(pool[w % npool], device))
        [t.cpu() for t in res]
    outputs.clear()
    marks.step("warmup")

    tracer = Tracer(model, tr, device, fam.STAGE_MODULES) if trace else None
    frames = []
    failed = 0
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i, pending = 0, None
    while True:
        idx = (tr["warmup_batches"] + i) % npool
        if tracer:
            tracer.before(i, idx)
        t_in = time.perf_counter()
        res = detect(_to(pool[idx], device))
        if tracer and tracer.active(i):
            tracer.clock.mark("postprocess")
        if pipelined:
            slot = ring[i % 2]
            for dst, src in zip(slot, res):
                dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event() if device.type == "cuda" else None
            if ev is not None:
                ev.record()
            if pending is not None:
                p_ev, p_slot, p_idx = pending
                if p_ev is not None:
                    p_ev.synchronize()
                valid, boxes, scores = land(p_slot, p_idx)
                failed += not (np.isfinite(boxes[valid]).all()
                               and np.isfinite(scores[valid]).all())
            pending = (ev, slot, idx)
        else:
            host = [t.cpu() for t in res]
            valid, boxes, scores = land(host, idx)
            kept = boxes[valid]
            frames.append((time.perf_counter() - t_in, tracer is not None
                           and tracer.profiled(i)))
            failed += not (np.isfinite(kept).all()
                           and np.isfinite(scores[valid]).all())
        if tracer:
            tracer.after(i)
        i += 1
        marks.ends.append(time.perf_counter())
        if marks.ends[-1] - t0 >= seconds and (
                tracer is None or tracer.done(i)):
            break
    if pending is not None:
        p_ev, p_slot, p_idx = pending
        if p_ev is not None:
            p_ev.synchronize()
        valid, boxes, scores = land(p_slot, p_idx)
        failed += not (np.isfinite(boxes[valid]).all()
                       and np.isfinite(scores[valid]).all())
    _sync(device)
    window = time.perf_counter() - t0
    peak = _peak(device)
    result = {"attempted": i * B, "failed": failed * B, "window_s": window,
              "setup_s": setup_s, "peak": peak,
              "infer_scenes_per_s": B * i / window,
              "setup_steps": marks.setup, "chunk_rates": marks.chunks(t0, B)}
    if frames:
        ms = sorted(f for f, _ in frames)
        result["frame_ms_p95"] = 1e3 * float(np.percentile(ms, 95))
    if tracer:
        result["trace"] = tracer.data(
            fam.work(m, False, B, [(j, pool[j]) for j in tracer.traced]),
            [f for f, traced in frames if not traced])
    del model, tracer, res, ring
    _free()

    rng = np.random.default_rng([int(seed), 99])
    pick = rng.choice(len(outputs), size=min(tr["check_batches"],
                                             len(outputs)), replace=False)
    ref = bench_check.InferReference(cell, seed, device)
    judged, scenes = [], []
    for j in sorted(pick):
        idx, out = outputs[j]
        for b in range(B):
            det = ref.scene(pool[idx], b)
            mine = {k: v[b] for k, v in out.items()}
            judged.append(bench_check.judge_scene(mine, det))
            scenes.append((idx, b, det))
    result["numbers"] = bench_check.infer_numbers(judged)
    result["checked_scenes"] = scenes
    result["pool"] = pool
    result["reference"] = ref
    return result


def run(cell, seed, seconds, trace, device, t_start, fault=None):
    fn = run_train if cell.traffic["kind"] == "train" else run_infer
    return fn(cell, seed, seconds, trace, device, t_start, fault)
