"""The reference's four examples on the port, one module each:
``quickstart`` (sync vs async Jacobi and value iteration under a
straggler, with and without Anderson), ``serve_batched`` (batched
prefill and decode, checked against teacher forcing), ``train_lm``
(training with a crash and a resume from the last checkpoint) and
``diloco_async`` (DiLoCo with a straggling pod).  Run them with
``python -m repro_torch.examples.<name> [--device cuda|cpu]``; they run
on the card by default and raise without one."""
