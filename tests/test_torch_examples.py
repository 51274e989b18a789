"""The port's three examples against the reference's, on the CPU.

``examples/torch_{quickstart,serve_kvstore,train_fault_tolerant}.py`` are
held to ``examples/{quickstart,serve_kvstore,train_fault_tolerant}.py``,
loaded by path:

* quickstart: the registry's history gives the same completions (tag for
  tag) and the same printed lines as the reference's scalar registry;
* serve_kvstore: with the reference's parameters carried over by
  ``params_from_reference``, the same routes, views and greedy token
  matrix (exact tokens), and the prefill within 1e-3 of max |logit| of
  the decode path;
* train_fault_tolerant at its small setting: resume at step 20, commits
  every 10 steps up to 40, the backup grant and a descending loss; the
  reference restores the port's step-20 checkpoint and its step-21 loss
  equals the port's within 1e-5 relative.

The reference's own 40 JAX training steps are not run here (time).
"""

import dataclasses
import importlib.util
import pathlib
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from repro.coord import registry as ref_registry_mod
from repro.core import sim as ref_sim
from repro.data import pipeline as ref_pipeline
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.serve import engine as ref_engine
from repro.train import loop as ref_loop
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.core import sim
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.train.loop import TrainConfig, train
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PREFILL_TOL = 1e-3
RESUME_TOL = 1e-5


def load(rel: str, name: str):
    """A file of the repo as a module, by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


ref_qs = load("examples/quickstart.py", "ref_quickstart")
ref_sk = load("examples/serve_kvstore.py", "ref_serve_kvstore")
qs = load("examples/torch_quickstart.py", "torch_quickstart")
sk = load("examples/torch_serve_kvstore.py", "torch_serve_kvstore")
tf = load("examples/torch_train_fault_tolerant.py",
          "torch_train_fault_tolerant")


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    made = []

    class Recorded(ref_registry_mod.PaxosRegistry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(ref_qs, "PaxosRegistry", Recorded)
    ref_qs.main()
    want_out = capsys.readouterr().out
    reg = qs.run(torch.device("cpu"))
    assert capsys.readouterr().out == want_out
    want = ref_sim.completion_tuples(made[0].cluster)
    assert len(want) == 9
    assert sim.completion_tuples(reg.cluster) == want
    assert qs.main(["--device", "cpu"]) == 0


def test_serve_kvstore_matches_the_reference(monkeypatch, capsys):
    engines, outs = [], []

    class Recorded(ref_engine.DecodeEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)

        def generate(self, *a, **k):
            outs.append(super().generate(*a, **k))
            return outs[-1]

    monkeypatch.setattr(ref_sk, "DecodeEngine", Recorded)
    ref_sk.main()
    want_lines = capsys.readouterr().out.splitlines()
    ref_params = jax.tree.map(np.asarray, engines[0].params)
    dev = torch.device("cpu")
    params = params_from_reference(sk.CFG, ref_params, device=dev)
    got = sk.serve(build_model(sk.CFG), params, dev)
    lines = capsys.readouterr().out.splitlines()
    assert lines[:-1] == want_lines
    assert lines[-1].startswith("prefill of the prompts agrees with the "
                                "decode path")
    np.testing.assert_array_equal(got["tokens"], outs[0])
    assert got["tokens"].shape == (4, 12)
    assert got["routes"] == {101: 0, 102: 1, 103: 0, 104: 1}
    assert got["prefill_err"] <= PREFILL_TOL
    view = got["registry"].cluster.active_view
    assert (view.epoch, view.members) == (2, (0, 1, 3, 4, 5))


def test_serve_kvstore_main_draws_from_a_seeded_generator(capsys):
    assert sk.main(["--device", "cpu"]) == 0
    first = capsys.readouterr().out
    assert sk.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out == first


def test_train_fault_tolerant_resumes_and_matches_the_reference(tmp_path):
    ckpt = tmp_path / "ckpt"
    got = tf.run(False, str(ckpt), torch.device("cpu"))
    reg = got["registry"]
    assert got["out1"]["start_step"] == 0
    assert got["out2"]["start_step"] == 20
    assert got["committed"] == [(10, True), (20, True), (30, True),
                                (40, True)]
    assert reg.latest_checkpoint(tf.RUN) == 40
    assert got["backup"] == (True, False)
    losses = got["losses"]
    assert [h["step"] for h in got["out1"]["history"]
            + got["out2"]["history"]] == [10, 20, 30, 40]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # exactly-once data: 40 steps at 4 batches a shard took 10 leases
    assert reg.fetch(f"data/{tf.RUN}/cursor") == 10

    # one step resumed from the port's step-20 checkpoint, in each package
    half, _, every = tf.settings(False)
    src = ckpt / tf.RUN / f"step_{half:08d}"
    data, opt = got["data"], got["opt"]
    tcfg = dict(run=tf.RUN, steps=half + 1, ckpt_every=every, log_every=1)
    runs = {}
    for name in ("port", "ref"):
        d = tmp_path / name
        shutil.copytree(src, d / tf.RUN / src.name)
        if name == "port":
            r = PaxosRegistry(n_machines=3, all_aboard=True)
        else:
            r = ref_registry_mod.PaxosRegistry(n_machines=3, all_aboard=True)
        assert r.commit_checkpoint(tf.RUN, half)
        assert r.faa(f"data/{tf.RUN}/cursor", half // 4) == 0
        if name == "port":
            out = train(got["model"], data, TrainConfig(ckpt_dir=str(d),
                                                        **tcfg),
                        opt, r, device="cpu")
        else:
            out = ref_loop.train(
                ref_build_model(RefModelConfig(
                    **dataclasses.asdict(got["model"].cfg))),
                ref_pipeline.DataConfig(**dataclasses.asdict(data)),
                ref_loop.TrainConfig(ckpt_dir=str(d), **tcfg),
                ref_adamw.AdamWConfig(**{
                    k: v for k, v in dataclasses.asdict(opt).items()
                    if k != "state_dtype"}), r)
        assert out["start_step"] == half
        runs[name] = out["history"]
    assert [h["step"] for h in runs["port"]] == \
        [h["step"] for h in runs["ref"]] == [half + 1]
    p, w = runs["port"][0]["loss"], runs["ref"][0]["loss"]
    assert abs(p / w - 1) <= RESUME_TOL, (p, w)


@pytest.mark.parametrize("mod", [qs, sk, tf], ids=lambda m: m.__name__)
def test_main_without_device_fails_loudly(mod, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device resolves to it")
    argv = ["--ckpt-dir", str(tmp_path)] if mod is tf else []
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main(argv)
