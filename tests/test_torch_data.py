"""The port's data path against the JAX package's, on the CPU.

The corpora draw from ``jax.random`` in the reference and from a
``torch.Generator`` in the port, so parity feeds the reference's token
arrays (and pairwise tables) to the port, and the port's own sampling is
checked by distribution. Encoder parameters are the reference's, carried
over with ``convert.encoder_params_from_numpy``.

* the Tab. 3 arrays and the other constants are equal;
* every function of ``data/pipeline.py`` matches to atol 2e-5;
* ``_std_meta`` uses the population std (ddof 0, as ``jnp.std``);
* ``openai_prompt_embeddings`` pads a short benchmark with index 0;
* the MixInstruct scoring, labels and ambiguity filter match exactly;
* the synthetic corpus and the MixInstruct dataset follow the reference's
  distributions;
* the slice as a whole: tokens -> the port's pipeline -> the port's
  ``env.run`` (FGTS, B 8, 16 ticks) on the reference's draws routes the
  same pairs as the JAX chain outside near-ties, with the cumulative
  regret to 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import fgts as jfgts
from repro.core import policy as jpol
from repro.data import mixinstruct as jmi
from repro.data import pipeline as jpipe
from repro.data import routerbench as jrb
from repro.data import synth as jsynth
from repro.encoder import model as jenc
from repro_torch import convert
from repro_torch.core import env as tenv
from repro_torch.core import fgts as tfgts
from repro_torch.core import policy as tpol
from repro_torch.data import mixinstruct as tmi
from repro_torch.data import pipeline as tpipe
from repro_torch.data import routerbench as trb
from repro_torch.data import synth as tsynth
from repro_torch.encoder import model as tenc
from test_torch_env import JaxDraws

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
NEAR_TIE = 1e-5
ENC = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4, d_ff=128,
           max_len=16)
CORPUS = dict(vocab_size=512, seq_len=16, common_pool=128, block_size=48)


def n(v):
    return np.asarray(v)


def tt(v):
    return torch.from_numpy(np.array(v))


@pytest.fixture(scope="module")
def world():
    """Reference encoder params and a RouterBench split at a tiny size, on
    both sides."""
    jc, tc = jenc.EncoderConfig(**ENC), tenc.EncoderConfig(**ENC)
    jp = jenc.init_encoder(jax.random.PRNGKey(0), jc)
    tp = convert.encoder_params_from_numpy(jax.device_get(jp), device="cpu")
    split = jrb.make_split(jax.random.PRNGKey(1),
                           jsynth.CorpusConfig(**CORPUS), t_online=128)
    return jc, tc, jp, tp, split, port_split(split)


def port_split(js):
    f = {k.name: getattr(js, k.name) for k in dataclasses.fields(js)}
    return trb.RouterBenchSplit(**{k: v if k == "benchmarks" else tt(v)
                                   for k, v in f.items()})


def test_tables_and_constants_equal():
    np.testing.assert_array_equal(trb.PERF, jrb.PERF)
    np.testing.assert_array_equal(trb.COST, jrb.COST)
    assert trb.PERF.dtype == trb.COST.dtype == np.float32
    assert trb.BENCHMARKS == jrb.BENCHMARKS and trb.LLMS == jrb.LLMS
    assert (trb.N_MODELS, trb.N_BENCHMARKS, trb.LAMBDA_COST) == (
        jrb.N_MODELS, jrb.N_BENCHMARKS, jrb.LAMBDA_COST)
    np.testing.assert_array_equal(tmi.FIRST_RANK_PCT, jmi.FIRST_RANK_PCT)
    assert tmi.MODELS == jmi.MODELS and tmi.N_MODELS == jmi.N_MODELS
    for kw in ({}, CORPUS, dict(block_overlap=0.5, common_pool=384,
                                block_size=224)):
        np.testing.assert_array_equal(
            tsynth.category_token_logits(tsynth.CorpusConfig(**kw)),
            jsynth.category_token_logits(jsynth.CorpusConfig(**kw)))
    np.testing.assert_allclose(n(trb.scores()), n(jrb.scores()), rtol=0)
    cats = np.array([0, 6, 3, 3], np.int32)
    np.testing.assert_array_equal(
        trb.utilities_for_stream(tt(cats), tt(trb.PERF)).numpy(),
        n(jrb.utilities_for_stream(jnp.asarray(cats),
                                   jnp.asarray(jrb.PERF))))


@pytest.mark.parametrize("weighting", ["perf", "perf_cost",
                                       "excel_perf_cost", "excel_mask"])
def test_routerbench_model_embeddings_match(world, weighting):
    jc, tc, jp, tp, js, ts = world
    want = jpipe.routerbench_model_embeddings(jp, jc, js, weighting)
    got = tpipe.routerbench_model_embeddings(tp, tc, ts, weighting)
    assert got.shape == (11, ENC["d_model"] + 14)
    np.testing.assert_allclose(got.numpy(), n(want), **TOL)


def test_model_embeddings_without_metadata_and_override(world):
    jc, tc, jp, tp, js, ts = world
    perf = np.flip(jrb.PERF, axis=0).copy()
    want = jpipe.routerbench_model_embeddings(
        jp, jc, js, "excel_perf_cost", tau=2, with_metadata=False,
        perf_override=jnp.asarray(perf))
    got = tpipe.routerbench_model_embeddings(
        tp, tc, ts, "excel_perf_cost", tau=2, with_metadata=False,
        perf_override=tt(perf))
    np.testing.assert_allclose(got.numpy(), n(want), **TOL)


@pytest.mark.parametrize("cost_aware", [True, False])
def test_routerbench_env_matches(world, cost_aware):
    jc, tc, jp, tp, js, ts = world
    want = jpipe.routerbench_env(jp, jc, js, cost_aware=cost_aware)
    got = tpipe.routerbench_env(tp, tc, ts, cost_aware=cost_aware)
    assert got.x.shape == (128, ENC["d_model"] + 14)
    np.testing.assert_allclose(got.x.numpy(), n(want.x), **TOL)
    np.testing.assert_array_equal(got.utils.numpy(), n(want.utils))
    assert got.feedback_scale == float(want.feedback_scale) == 8.0


def test_openai_and_mean_embeddings_match(world):
    jc, tc, jp, tp, js, ts = world
    want = jpipe.openai_prompt_embeddings(jp, jc, js)
    got = tpipe.openai_prompt_embeddings(tp, tc, ts)
    np.testing.assert_allclose(got.numpy(), n(want), **TOL)
    want = jpipe.mean_embeddings(jp, jc, js)
    got = tpipe.mean_embeddings(tp, tc, ts)
    np.testing.assert_allclose(got.numpy(), n(want), **TOL)


def test_openai_prompt_pads_a_short_benchmark_with_index_0(world):
    """Every model's best benchmark in Tab. 3 is MT-Bench. Leave it two
    offline queries of 4 tokens: each prompt is those two, then offline
    query 0 three times (``jnp.where``'s fill), concatenated and cut to
    max_len = 16 tokens."""
    jc, tc, jp, tp, js, ts = world
    best = int(np.argmax(jrb.PERF[0]))
    assert np.all(np.argmax(jrb.PERF, axis=1) == best)
    cats = np.array(js.offline_cats)
    hits = np.nonzero(cats == best)[0]
    cats[hits[2:]] = (best + 1) % len(js.benchmarks)
    tok = n(js.offline_tokens)[:, :4]
    short = dataclasses.replace(js, offline_cats=jnp.asarray(cats),
                                offline_tokens=jnp.asarray(tok))
    want = jpipe.openai_prompt_embeddings(jp, jc, short, n_queries=5)
    got = tpipe.openai_prompt_embeddings(
        tp, tc, dataclasses.replace(ts, offline_cats=tt(cats),
                                    offline_tokens=tt(tok)), n_queries=5)
    np.testing.assert_allclose(got.numpy(), n(want), **TOL)
    prompt = np.concatenate([tok[hits[0]], tok[hits[1]], tok[0], tok[0]])
    emb = tenc.encode(tp, tt(prompt[None]), torch.ones((1, 16)), tc)[0]
    np.testing.assert_allclose(got[:, :ENC["d_model"]].numpy(),
                               np.broadcast_to(emb.numpy(), (11, 64)), **TOL)


def test_std_meta_is_population_std():
    meta = np.concatenate([trb.PERF, trb.COST], axis=-1)
    want = 0.3 * (meta - meta.mean(0)) / meta.std(0, ddof=0)
    got = tpipe._std_meta(tt(trb.PERF), tt(trb.COST)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, n(jpipe._std_meta(jnp.asarray(jrb.PERF), jnp.asarray(jrb.COST))),
        rtol=1e-5, atol=1e-6)
    ddof1 = 0.3 * (meta - meta.mean(0)) / meta.std(0, ddof=1)
    assert np.abs(got - ddof1).max() > 1e-2


@pytest.fixture(scope="module")
def mix_data():
    corpus = jsynth.CorpusConfig(**CORPUS)
    cfg = jmi.MixInstructConfig(n_queries=240)
    return jmi.make_dataset(jax.random.PRNGKey(2), corpus, cfg)


def test_mixinstruct_scoring_matches_exactly(mix_data):
    table = mix_data["pairwise"]
    np.testing.assert_allclose(
        tmi.scores_from_pairwise(tt(table)).numpy(),
        n(jmi.scores_from_pairwise(table)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tmi.best_model_labels(tt(table)).numpy(),
                                  n(jmi.best_model_labels(table)))
    np.testing.assert_allclose(tmi.ambiguity_scores(tt(table)).numpy(),
                               n(jmi.ambiguity_scores(table)), rtol=0,
                               atol=1e-6)
    tdata = {k: tt(v) for k, v in mix_data.items()}
    for frac in (0.08, 0.15):
        want = jmi.remove_ambiguous(mix_data, frac)
        got = tmi.remove_ambiguous(tdata, frac)
        for k in mix_data:
            np.testing.assert_array_equal(got[k].numpy(), n(want[k]),
                                          err_msg=k)


def test_best_model_labels_take_the_first_index_on_ties():
    """Models 2 and 5 beat everyone else and tie with each other: the label
    is 2, as ``jnp.argmax`` gives it."""
    table = np.full((1, 11, 11), 0.0, np.float32)
    table[0, [2, 5], :] = 1.0
    table[0, :, [2, 5]] = 0.0
    table[0, 2, 5] = table[0, 5, 2] = 0.5
    table[0, np.arange(11), np.arange(11)] = 0.5
    assert tmi.best_model_labels(tt(table)).tolist() == [2]
    assert n(jmi.best_model_labels(jnp.asarray(table))).tolist() == [2]


def test_mixinstruct_env_and_embeddings_match(world, mix_data):
    jc, tc, jp, tp, _, _ = world
    want_env, want_a = jpipe.mixinstruct_env_and_embeddings(
        jp, jc, mix_data, n_offline=60)
    got_env, got_a = tpipe.mixinstruct_env_and_embeddings(
        tp, tc, {k: tt(v) for k, v in mix_data.items()}, n_offline=60)
    np.testing.assert_allclose(got_a.numpy(), n(want_a), **TOL)
    np.testing.assert_allclose(got_env.x.numpy(), n(want_env.x), **TOL)
    np.testing.assert_allclose(got_env.utils.numpy(), n(want_env.utils),
                               rtol=0, atol=1e-6)
    assert got_env.feedback_scale == 8.0


def test_synth_sampling_follows_the_token_distribution():
    """Per category, every token's frequency in 400 x 16 draws lies within
    6 binomial standard deviations (+ 1e-4) of softmax(logits[m]), the
    distribution ``jax.random.categorical`` samples in the reference."""
    cfg = tsynth.CorpusConfig(**CORPUS)
    gen = torch.Generator().manual_seed(0)
    per_cat = 400
    tok, mask, cats = tsynth.make_split(gen, per_cat, cfg, device="cpu")
    assert tok.shape == (7 * per_cat, 16) and tok.dtype == torch.int32
    assert mask.dtype == torch.float32 and bool((mask == 1).all())
    assert torch.bincount(cats.long()).tolist() == [per_cat] * 7
    assert cats[:per_cat].unique().numel() > 1            # shuffled
    probs = tsynth.token_probs(cfg).double().numpy()
    np.testing.assert_allclose(
        probs, jax.nn.softmax(jsynth.category_token_logits(
            jsynth.CorpusConfig(**CORPUS)), axis=-1), rtol=1e-5, atol=1e-8)
    n_tok = per_cat * cfg.seq_len
    for m in range(7):
        counts = np.bincount(tok[cats == m].flatten().numpy(),
                             minlength=cfg.vocab_size)
        freq, p = counts / n_tok, probs[m]
        bound = 6 * np.sqrt(p * (1 - p) / n_tok) + 1e-4
        assert np.all(np.abs(freq - p) <= bound), m
    # the same generator seed gives the same tokens
    again = tsynth.make_split(torch.Generator().manual_seed(0), per_cat, cfg,
                              device="cpu")
    assert torch.equal(again[0], tok)


def test_mixinstruct_dataset_follows_the_reference_distribution():
    """The port's dataset against the reference's (same config, own
    draws). Skills: the calibrated base per model (exact) plus category
    deviations centred per model. Utilities: skill of the query's latent
    category plus N(0, 0.12) noise. Tables: antisymmetric with 0.5 on the
    diagonal, the reference's tie rate within 0.02, the head model (Tab. 2's
    first) most often best."""
    corpus = tsynth.CorpusConfig(**CORPUS)
    n_q = 600
    cfg = tmi.MixInstructConfig(n_queries=n_q)
    skills = tmi.latent_skills(torch.Generator().manual_seed(1), cfg)
    j_skills = jmi.latent_skills(jax.random.PRNGKey(1),
                                 jmi.MixInstructConfig(n_queries=n_q))
    np.testing.assert_allclose(skills.mean(1).numpy(), n(j_skills).mean(1),
                               rtol=0, atol=1e-6)
    got = tmi.make_dataset(torch.Generator().manual_seed(0), corpus, cfg,
                           device="cpu")
    want = jmi.make_dataset(jax.random.PRNGKey(0),
                            jsynth.CorpusConfig(**CORPUS),
                            jmi.MixInstructConfig(n_queries=n_q))
    for data in (got, want):
        utils, cats = n(data["utils"]), n(data["cats"])
        means = np.stack([utils[cats == m].mean(0) for m in range(8)])
        resid = utils - means[cats]
        assert abs(resid.std() - cfg.utility_noise) < 0.01
    table = got["pairwise"]
    assert table.shape == (n_q, 11, 11)
    assert torch.equal(table + table.transpose(1, 2), torch.ones_like(table))
    assert set(table.unique().tolist()) == {0.0, 0.5, 1.0}
    ties = float((table == 0.5).float().mean())
    assert abs(ties - float(jnp.mean(want["pairwise"] == 0.5))) < 0.02
    for labels in (tmi.best_model_labels(table).numpy(),
                   n(jmi.best_model_labels(want["pairwise"]))):
        assert int(np.argmax(np.bincount(labels, minlength=11))) == 0
    assert got["tokens"].shape == (n_q, corpus.seq_len)
    assert got["utils"].shape == (n_q, 11)


def test_port_splits_have_the_reference_layout():
    corpus = tsynth.CorpusConfig(**CORPUS)
    gen = torch.Generator().manual_seed(3)
    s = trb.make_split(gen, corpus, t_online=50, device="cpu")
    assert s.offline_tokens.shape == (35, 16) and s.online_cats.shape == (50,)
    assert torch.bincount(s.offline_cats.long()).tolist() == [5] * 7
    assert s.perf.shape == s.cost.shape == (11, 7)
    s2 = trb.make_split(gen, corpus, t_online=8,
                        benchmarks=["GSM8k", "MMLU"], device="cpu")
    np.testing.assert_array_equal(s2.perf.numpy(), trb.PERF[:, [5, 0]])
    g, unseen = trb.make_generalization_split(gen, corpus, device="cpu")
    assert unseen == 5 and g.benchmarks[unseen] == "ARC"
    assert int(g.offline_cats.max()) < unseen
    on = g.online_cats
    assert on.shape == (720,) and int((on[:300] == unseen).sum()) == 0
    assert int((on[300:] == unseen).sum()) == 120


def _gaps(x, a, th1, th2, a1):
    """Per row the top-1 minus top-2 score gap under sample 1, and under
    sample 2 without a1 (force_distinct), relative to max|s|."""
    def scores(th):
        num = (x * th) @ a.T
        return num / np.sqrt(np.maximum((x * x) @ (a * a).T, 1e-24))
    s1, s2 = scores(th1), scores(th2)
    s2[np.arange(len(a1)), a1] = -np.inf
    gap = lambda s: np.diff(np.sort(s, axis=-1)[:, -2:], axis=-1)[:, 0]
    scale = max(np.abs(s1).max(), np.abs(s2[np.isfinite(s2)]).max())
    return np.minimum(gap(s1), gap(s2)) / scale


def test_slice_routes_the_reference_pairs(world):
    """Tokens -> encoder -> excel_perf_cost model embeddings and the online
    env -> FGTS.CDB, B 8 for 16 ticks, on the reference's draws."""
    jc, tc, jp, tp, js, ts = world
    j_a = jpipe.routerbench_model_embeddings(jp, jc, js, "excel_perf_cost")
    j_env = jpipe.routerbench_env(jp, jc, js)
    t_a = tpipe.routerbench_model_embeddings(tp, tc, ts, "excel_perf_cost")
    t_env = tpipe.routerbench_env(tp, tc, ts)
    base = dict(n_models=11, dim=ENC["d_model"] + 14, horizon=128, eta=8.0,
                mu=0.2, sgld_steps=4, sgld_eps=5e-4, sgld_minibatch=16,
                n_chains=2)
    key = jax.random.PRNGKey(4)
    aux = lambda s, a1, a2: (a1, a2, s.theta1.mean(0), s.theta2.mean(0))
    j_cum, _, (j1, j2, th1, th2) = jenv.run(
        key, j_env, jpol.fgts_policy(j_a, jfgts.FGTSConfig(**base)), batch=8,
        aux_fn=aux)
    t_cum, _, (t1, t2, _, _) = tenv.run(
        JaxDraws(key), t_env, tpol.fgts_policy(t_a, tfgts.FGTSConfig(**base)),
        batch=8, aux_fn=aux)
    x = n(j_env.x).reshape(16, 8, -1)
    a = n(j_a)
    gaps = np.stack([_gaps(x[s], a, n(th1[s]), n(th2[s]), n(j1[s]))
                     for s in range(16)])
    print(f"smallest relative top-2 gap met: {gaps.min():.3e}")
    bad = (t1.numpy() != n(j1)) | (t2.numpy() != n(j2))
    ticks = np.nonzero(bad.any(axis=1))[0]
    if ticks.size:
        first = int(ticks[0])
        print(f"first pair mismatch at tick {first}, gaps "
              f"{gaps[first][bad[first]]}")
        assert np.all(gaps[first][bad[first]] <= NEAR_TIE), \
            "pairs differ outside near-ties"
    else:
        first = 16
    np.testing.assert_allclose(t_cum.numpy()[:8 * first],
                               n(j_cum)[:8 * first], rtol=1e-5)
    assert first == 16, "a near-tie flip cut the comparison short"
