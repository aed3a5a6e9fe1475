"""The check fails what it must: the control (the reference in float8 e4m3,
its query arithmetic in bfloat16 and its distances in TF32, put in the
program's place) reads past a limit, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced. One process, one card: there is no
exchange between chips to leave out. The harness's look for a chip is
skipped; everything else is the run's own code at the tiny CPU size."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from rald_bench import readings
from rald_bench import run as bench_run

SEED = 2 ** 31 + 777


def _run(cell):
    return bench_run.run(cell, SEED, 1.0, False, device="cpu", log=lambda s: None)


@pytest.mark.parametrize("name", ["tiny_eval_b2", "tiny_train_b2"])
def test_control_fails_a_limit(tiny_cell, name):
    cell = tiny_cell(name)
    (line,) = readings.readings(cell, [SEED], control=True, int8=False, device="cpu",
                                log=lambda s: None)
    limits = cell["limits"]["limits"]
    assert all(line["numbers"][n] <= limits[n] for n in limits)
    assert any(line["control"][n] > limits[n] for n in limits)


def _eval_fault(monkeypatch, fault):
    from rald_torch.train import gen_engine

    eng_cls = gen_engine.GenerationEngine
    if fault == "unchanged":  # the sampler hands its starting state back
        monkeypatch.setattr(eng_cls, "sample_from_cond",
                            lambda self, cond, prior, capture_states=False:
                            torch.as_tensor(np.asarray(prior), device=self.device).float())
    elif fault == "half":  # the step runs the first half of the batch; the rest repeats it
        step = eng_cls.fused_eval_step

        def half(self, cube, prior, q_eval, labels, qmask, grid, gen, helper, helper_mask, surface,
                 surface_mask, **kw):
            n = len(cube) // 2
            out = step(self, cube[:n], prior[:n], q_eval[:n], labels[:n], qmask[:n], grid, gen,
                       helper[:n], helper_mask[:n], surface[:n], surface_mask[:n], **kw)
            return out[:3] + tuple(torch.cat([t, t]) for t in out[3:])

        monkeypatch.setattr(eng_cls, "fused_eval_step", half)
    else:  # the Chamfer distance altered where it is produced
        cd_f = gen_engine.batched_cd_fscore_graph
        monkeypatch.setattr(gen_engine, "batched_cd_fscore_graph",
                            lambda *a, **kw: (lambda cd, f: (cd * 1.001, f))(*cd_f(*a, **kw)))


def _train_fault(monkeypatch, fault):
    from rald_torch.train import gen_engine, state

    if fault == "unchanged":  # the update leaves the state as it was
        monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self, grads: False)
    elif fault == "half":  # the loss is the mean over the first half of the batch
        lag = gen_engine.GenerationEngine.loss_and_grads

        def half(self, latents, cube, generator=None, rnd=None, noise=None, timings=None):
            n = len(latents) // 2
            return lag(self, latents[:n], cube[:n], generator, rnd[:n], noise[:n], timings)

        monkeypatch.setattr(gen_engine.GenerationEngine, "loss_and_grads", half)
    else:  # the loss altered where it is produced
        loss = gen_engine.edm_loss
        monkeypatch.setattr(gen_engine, "edm_loss", lambda *a, **kw: loss(*a, **kw) * 1.01)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["tiny_eval_b2", "tiny_train_b2"])
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    assert _run(cell)["correct"] is True
    (_eval_fault if name.startswith("tiny_eval") else _train_fault)(monkeypatch, fault)
    out = _run(cell)
    assert out["correct"] is False
