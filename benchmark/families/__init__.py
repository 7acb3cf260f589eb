"""Model families: a configuration file names its family under
``"family"`` (``uni3detr`` where it names none), and the family is the
module ``families/<family>.py``, found by that name
(``bench_cell.family``). A family is the one place of the harness that
knows the model. The runners (``bench_drive``), the comparison
(``bench_check``), the count (``bench_count``) and the trace
(``bench_trace``) call these names of it, each of which it defines:

The program (the port, imported inside the functions)

- ``port_config(model)``: the port's configuration dataclass from the
  configuration file's ``model`` dict.
- ``build(cfg)``: the port's model of that dataclass, an ``nn.Module``
  on the CPU.
- ``train_batch(seed, model, batch, index)`` and ``infer_batch(seed,
  model, batch, index)``: batch ``index`` of a train or an inference
  pool, host NumPy arrays by name, drawn from ``seed`` and the ``model``
  dict. A train batch is what the port's ``train.step.train_step``
  takes (``gt_boxes`` bottom z, ``gt_labels``, ``gt_mask`` beside the
  inputs); an inference batch is what ``infer`` takes.
- ``infer(model, batch)``: the inference call on a batch on the device,
  returning the head outputs that the port's
  ``train.coder.decode_predictions`` takes.
- ``optimizer_kwargs(config)``: the keyword arguments of the port's
  ``train.step.make_optimizer`` beyond the learning rate, weight decay,
  clip and momentum schedule (such as ``lr_mult``), from the whole
  configuration file.
- ``weight_rule``: None, or ``rule(kind, name, module, leaf, tensor)``
  giving a floating state entry's draw ``(family, a, b)`` as
  ``bench_weights`` spells it, or None to leave the entry to the shared
  rules; it is tried first, on the port's model and on the reference
  alike, whose entries of one name have to draw alike.

The reference (plain PyTorch and NumPy under ``reference/``, nothing of
the port)

- ``reference(model)``: the reference detector of the ``model`` dict,
  an ``nn.Module`` whose state dict has the port's names.
- ``reference_forward(ref, batch, quant)``: its head outputs on a train
  batch on the device.
- ``reference_scene(ref, batch, b, device, quant)``: its head outputs of
  scene ``b`` of a host inference batch, the scene's batch axis taken
  away.
- ``reference_loss(outs, batch, model)``: the training loss of a
  batch's outputs.
- ``reference_detect(outs, model)``: one scene's outputs -> its
  candidates and their ``kept`` mask, host arrays in the layout that
  ``bench_check.judge_scene`` reads.
- ``quantizer(precision)``: the ``quant`` that ``reference_forward`` and
  ``reference_scene`` take for ``float32`` (the reference), ``bfloat16``
  (the witness), ``float8`` and ``float8_alone`` (the controls).

The trace and the count

- ``STAGE_MODULES``: ``((stage, attribute of the port's model), ...)``
  in the order the forward runs them; each stage ends where its module
  returns, and the last ends the forward (``bench_trace.StageClock``).
- ``work(model, train, batch, batches)``: the ``bench_count.Work`` of
  the traced iterations, ``batches`` holding each one's pool index and
  host batch.
"""
