"""The port's two paper examples (``examples/quickstart_torch.py``,
``examples/mixinstruct_preferences_torch.py``) against the reference's
library calls in the reference examples' order, on the CPU.

The reference side builds its world and encoder from a JAX key and runs
the steps of ``examples/quickstart.py`` and
``examples/mixinstruct_preferences.py`` with the reference's functions
(the examples themselves take no sizes; the world and the embeddings are
jitted, which only saves the op-by-op compiles of their first eager call).
The port's ``run`` gets the same world and encoder weights carried over
(``convert.encoder_params_from_numpy``) and ``JaxDraws`` on the same key,
so its fine-tuning pairs and its SGLD and feedback draws are the
reference's: the routed pairs must be equal, the cumulative regret within
1e-5, the fine-tuning's epoch losses within 1e-5 (as
``test_torch_contrastive.py`` holds them), the last rounds' picks
(quickstart) and the kept queries and their labels (mixinstruct) equal.
The sizes are cut (T 30, 2 x 3 fine-tuning steps, 3 SGLD steps, 120
MixInstruct queries); the encoder and the corpus are the examples' own.
Each example's ``main`` also runs once with ``--device cpu`` at a tiny
size (24 rounds, 100 queries, one epoch of 2 steps, the examples' own SGLD
steps).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.contrastive import finetune as jft
from repro.core import env as jenv
from repro.core import fgts as jfgts
from repro.core import policy as jpol
from repro.core.ccft import scores_all as jscores_all
from repro.data import mixinstruct as jmi
from repro.data import pipeline as jpipe
from repro.data import routerbench as jrb
from repro.data.synth import CorpusConfig
from repro.encoder import model as jenc
from repro_torch import convert
from repro_torch.data import routerbench as trb
from test_torch_env import JaxDraws

torch.set_num_threads(2)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ENC = dict(d_model=128, n_layers=2, n_heads=4, d_ff=512)
CUT = dict(epochs=2, steps_per_epoch=3, sgld_steps=3)


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def n(v):
    return np.asarray(v)


def tt(v):
    return torch.from_numpy(np.array(v))


def _reference_online(k_run, e, a_emb, **cfg):
    """FGTS.CDB through the reference's ``env.run`` (jitted, as the
    examples run it), with each tick's pair."""
    pol = jpol.fgts_policy(a_emb, jfgts.FGTSConfig(**cfg))
    return jax.jit(lambda k: jenv.run(
        k, e, pol, aux_fn=lambda s, a1, a2: (a1, a2)))(k_run)


def _split(key, t_online):
    """``routerbench.make_split`` as the quickstart draws it."""
    names = [f.name for f in dataclasses.fields(jrb.RouterBenchSplit)
             if f.name != "benchmarks"]
    make = jax.jit(lambda k: {f: getattr(jrb.make_split(
        k, CorpusConfig(seq_len=32), n_offline_per_cat=5,
        t_online=t_online), f) for f in names})
    return jrb.RouterBenchSplit(**make(key),
                                benchmarks=tuple(jrb.BENCHMARKS))


_init_encoder = jax.jit(jenc.init_encoder, static_argnums=1)


def _encoder(key, jc):
    """``encoder.init_encoder`` (jitted once for both examples), on the
    host."""
    return jax.device_get(_init_encoder(key, jc))


def _pairs(aux):
    a1, a2 = aux
    return np.stack([n(a1), n(a2)], axis=-1)[:, 0]


def test_quickstart_matches_the_reference_steps():
    ex = _example("quickstart_torch")
    assert ex.ENC_CFG == ex.EncoderConfig(**ENC)
    t_online = 30
    k_world, k_enc, k_draw = jax.random.split(jax.random.PRNGKey(0), 3)
    split = _split(k_world, t_online)
    jc = jenc.EncoderConfig(**ENC)
    enc = _encoder(k_enc, jc)

    k_ft, k_run = jax.random.split(k_draw, 2)
    enc_ft, losses = jft.finetune_categorical(
        k_ft, enc, split.offline_tokens, split.offline_mask,
        split.offline_cats, jc, epochs=CUT["epochs"],
        steps_per_epoch=CUT["steps_per_epoch"])
    a_emb, e = jax.jit(lambda p: (
        jpipe.routerbench_model_embeddings(p, jc, split, "excel_perf_cost"),
        jpipe.routerbench_env(p, jc, split)))(enc_ft)
    cum, state, aux = _reference_online(
        k_run, e, a_emb, n_models=jrb.N_MODELS, dim=e.x.shape[1],
        horizon=t_online, eta=8.0, mu=0.2, sgld_steps=CUT["sgld_steps"],
        sgld_eps=5e-4, sgld_minibatch=64)
    theta = state.theta1.mean(axis=0)
    picks = jax.jit(jax.vmap(lambda x: jnp.argmax(jscores_all(
        x, a_emb, theta))))(e.x[t_online - ex.N_PICKS:]).tolist()

    fields = {f.name: getattr(split, f.name)
              for f in dataclasses.fields(split)}
    tsplit = trb.RouterBenchSplit(**{k: v if k == "benchmarks" else tt(v)
                                     for k, v in fields.items()})
    got = ex.run(tsplit, convert.encoder_params_from_numpy(enc, "cpu"),
                 JaxDraws(k_draw), **CUT)
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["a_emb"].numpy(), n(a_emb), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got["pairs"].numpy(), _pairs(aux))
    np.testing.assert_allclose(got["cum"].numpy(), n(cum), rtol=1e-5)
    assert got["picks"].tolist() == picks


def test_mixinstruct_matches_the_reference_steps():
    ex = _example("mixinstruct_preferences_torch")
    assert ex.ENC_CFG == ex.EncoderConfig(**ENC)
    k_data, k_enc, k_draw = jax.random.split(jax.random.PRNGKey(1), 3)
    data = jax.jit(lambda k: jmi.make_dataset(
        k, CorpusConfig(n_categories=8, seq_len=32),
        jmi.MixInstructConfig(n_queries=120)))(k_data)
    jc = jenc.EncoderConfig(**ENC)
    enc = _encoder(k_enc, jc)

    k_ft, k_run = jax.random.split(k_draw, 2)

    def prelude(d):
        kept = jmi.remove_ambiguous(dict(d, index=jnp.arange(120)),
                                    ex.REMOVE)
        return (jmi.ambiguity_scores(d["pairwise"]), kept,
                jmi.best_model_labels(kept["pairwise"]))
    amb, kept, labels = jax.jit(prelude)(data)
    index = kept.pop("index")
    off = ex.N_OFFLINE
    enc_ft, losses = jft.finetune_categorical(
        k_ft, enc, kept["tokens"][:off], kept["mask"][:off], labels[:off],
        jc, epochs=CUT["epochs"], steps_per_epoch=CUT["steps_per_epoch"])
    e, a_emb = jax.jit(lambda p: jpipe.mixinstruct_env_and_embeddings(
        p, jc, kept, n_offline=off))(enc_ft)
    cum, _, aux = _reference_online(
        k_run, e, a_emb, n_models=jmi.N_MODELS, dim=e.x.shape[1],
        horizon=e.x.shape[0], sgld_steps=CUT["sgld_steps"],
        sgld_minibatch=64)
    assert e.x.shape[0] > 20

    got = ex.run({k: tt(v) for k, v in data.items()},
                 convert.encoder_params_from_numpy(enc, "cpu"),
                 JaxDraws(k_draw), **CUT)
    np.testing.assert_allclose(got["ambiguity"].numpy(), n(amb), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["kept"].numpy(), n(index))
    np.testing.assert_array_equal(got["labels"].numpy(), n(labels))
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["a_emb"].numpy(), n(a_emb), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got["pairs"].numpy(), _pairs(aux))
    np.testing.assert_allclose(got["cum"].numpy(), n(cum), rtol=1e-5)


@pytest.mark.parametrize("name, size", [
    ("quickstart_torch", ["--rounds", "24"]),
    ("mixinstruct_preferences_torch", ["--queries", "100"])])
def test_example_main_runs_on_the_cpu(name, size):
    """``main`` with ``--device cpu`` at a tiny size: a finite regret
    curve over the online rounds, a slope ratio, one loss an epoch."""
    out = _example(name).main(["--device", "cpu", "--epochs", "1",
                               "--steps-per-epoch", "2", *size])
    assert len(out["regret"]) == out["rounds"] > 10
    assert np.isfinite(out["regret"]).all()
    assert np.isfinite(out["slope_ratio"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    if name == "quickstart_torch":
        assert out["rounds"] == 24 and len(out["picks"]) == 10
        assert out["encoded"] == [35, 24]
    else:
        assert out["kept"] == 92 and len(out["labels"]) == 92
        assert out["encoded"] == [92] and out["rounds"] == 92 - 80
