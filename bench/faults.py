"""Faults planted underneath the timed path, for the tests of ``correct``
and for reading each fault's numbers on the chip (``calibrate.py``):

  ``unchanged_state``  the train step returns the params and optimizer
                       state it was given;
  ``half_batch``       the train step sees the first half of the batch's
                       rows, its mean taken over them;
  ``altered_token``    the server's answer for every request is moved to
                       the next token id where it is produced.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged_state", "half_batch", "altered_token")


@contextlib.contextmanager
def planted(kind: str):
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    if kind == "altered_token":
        import numpy as np
        from repro_torch.runtime.server import MoEServer
        orig = MoEServer.serve_batch

        def serve_batch(self, *a, **kw):
            res = orig(self, *a, **kw)
            return res._replace(logits=np.roll(res.logits, 1, axis=-1))
        MoEServer.serve_batch = serve_batch
        try:
            yield
        finally:
            MoEServer.serve_batch = orig
        return
    from repro_torch.runtime import trainer
    orig = trainer.make_train_step

    def make_train_step(*a, **kw):
        real = orig(*a, **kw)

        def step(params, opt_state, batch, *rest):
            if kind == "half_batch":
                n = batch["tokens"].shape[0] // 2
                return real(params, opt_state,
                            {k: v[:n] for k, v in batch.items()}, *rest)
            _, _, met = real(params, opt_state, batch, *rest)
            return params, opt_state, met
        step.reduced_grads = real.reduced_grads
        return step
    trainer.make_train_step = make_train_step
    try:
        yield
    finally:
        trainer.make_train_step = orig
