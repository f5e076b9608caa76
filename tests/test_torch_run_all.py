"""The port's streaming driver (``pipeline/run_all.py``) on tiny models,
mirroring ``tests/test_run_all.py``: end to end, a downstream failure that
must not deadlock, error propagation, the contact filter, keep-top-match
and the validity gate; plus one run of JAX's and the port's driver on the
same fixed consensus and the same decoded token rows, whose counters and
aligned SMILES per hypothesis must be equal (the draws differ, so the
clouds and conformers differ; nothing the counters read depends on them
on these small molecules). The host chemistry the driver reaches
(``chem/ppgraph.py``, ``chem/match.py``, ``chem/native.py``) is held
equal to the JAX package's.

The tiny models' weights are one flax init (jitted: the eager init costs
~25 s of op compiles) converted to the port.
"""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu.chem import match as jmatch
from cmdgen_tpu.chem import ppgraph as jppgraph
from cmdgen_tpu.chem.tokenizer import Tokenizer as JTokenizer
from cmdgen_tpu.chem.tokenizer import gen_vocabs as jgen_vocabs
from cmdgen_tpu.config import GCPGModelConfig as JGCPGModelConfig
from cmdgen_tpu.config import to_dict
from cmdgen_tpu.diffusion.cddpm import ConditionalDDPM as JConditionalDDPM
from cmdgen_tpu.diffusion.cddpm import DDPMConfig as JDDPMConfig
from cmdgen_tpu.models.dynamics import DynamicsConfig as JDynamicsConfig
from cmdgen_tpu.models.dynamics import EGNNDynamics as JEGNNDynamics
from cmdgen_tpu.models.egnn import EGNNConfig as JEGNNConfig
from cmdgen_tpu.models.gcpg import GCPG as JGCPG
from cmdgen_tpu.pipeline import run_all as jrun_all
from cmdgen_tpu_torch.chem import match, native, ppgraph
from cmdgen_tpu_torch.chem.mol import mol_from_smiles
from cmdgen_tpu_torch.chem.sdf import read_sdf
from cmdgen_tpu_torch.chem.tokenizer import Tokenizer, gen_vocabs
from cmdgen_tpu_torch.config import GCPGModelConfig, from_dict
from cmdgen_tpu_torch.convert import build_gcpg, load_flax_params
from cmdgen_tpu_torch.diffusion.cddpm import ConditionalDDPM, DDPMConfig
from cmdgen_tpu_torch.models.dynamics import DynamicsConfig, EGNNDynamics
from cmdgen_tpu_torch.pipeline import run_all

torch.set_num_threads(1)

N_Q = 12
VOCAB = ["CCO", "OCC", "CO"]
POOL = ["CCO", "OCCO", "CCOC", "CO", "C(", "CCO", "OCO", "CCCO"]
STAT_KEYS = ("pockets", "hypotheses", "raw_smiles", "valid_smiles", "unique_smiles",
             "matched", "aligned")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The flax tiny models of tests/test_run_all.py, their params, the
    port's models built from them, the tokenizers and two pockets."""
    jdyn_cfg = JDynamicsConfig(phar_nf=8, residue_nf=11, joint_nf=8, edge_cutoff=None,
                               egnn=JEGNNConfig(hidden_nf=16, n_layers=1, inv_sublayers=1))
    jdyn = JEGNNDynamics(jdyn_cfg)
    jdiff = JConditionalDDPM(JDDPMConfig(timesteps=4), jdyn)
    diff_params = jax.jit(jdyn.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 4, 11)), jnp.zeros((2, N_Q, 14)),
        jnp.zeros((2, 1)), jnp.ones((2, 4)), jnp.ones((2, N_Q)))
    jtok = JTokenizer(jgen_vocabs(VOCAB))
    jgcfg = JGCPGModelConfig(max_len=12, hidden_dim=32, n_layers=1, ff_dim=32, n_head=4,
                             pp_encoder_n_layer=1, dropout=0.0)
    jgcpg = JGCPG(jgcfg, vocab_size=len(jtok))
    b = 2
    gparams = jax.jit(jgcpg.init)(
        jax.random.PRNGKey(2), jax.random.PRNGKey(3), jnp.zeros((b, 5), dtype=jnp.int32),
        jnp.ones((b, 5)), jnp.zeros((b, 8, 8)), jnp.zeros((b, 8, 8, 1)), jnp.ones((b, 8)),
        jnp.zeros((b, 5), dtype=jnp.int32), jnp.zeros((b, 7)))
    dyn = EGNNDynamics(from_dict(DynamicsConfig, to_dict(jdyn_cfg)))
    load_flax_params(dyn, _np(diff_params["params"]))
    diff = ConditionalDDPM(from_dict(DDPMConfig, to_dict(JDDPMConfig(timesteps=4))), dyn.eval())
    tok = Tokenizer(gen_vocabs(VOCAB))
    gcpg = build_gcpg(from_dict(GCPGModelConfig, to_dict(jgcfg)), _np(gparams["params"]),
                      len(tok), "cpu")
    rng = np.random.RandomState(0)
    pockets = [(rng.randn(N_Q, 3).astype(np.float32) * 3.0,
                np.eye(11, dtype=np.float32)[rng.randint(0, 11, N_Q)]) for _ in range(2)]
    return dict(jdiff=jdiff, diff_params=diff_params, jgcpg=jgcpg, gparams=gparams,
                jtok=jtok, diff=diff, gcpg=gcpg, tok=tok, pockets=pockets)


def fixed_consensus(coords, families, n_clusters=4, seed=0, device=None):
    """A hypothesis the C/O-vocabulary decodes can match."""
    c = np.asarray(coords).mean(0)
    return [("HYBL", c), ("HACC", c + np.asarray([2.5, 0, 0]))]


def _token_rows(tok, b, smiles_of_row):
    out = np.full((b, 12), tok.s2i["<pad>"], dtype=np.int64)
    for i in range(b):
        ids = tok.parse(smiles_of_row(i))[1:][:12]  # drop <sos>
        out[i, : len(ids)] = ids
    return out


def _fake_generate(tok, smiles_of_row=lambda i: POOL[i % len(POOL)], calls=None):
    """The port's generate replaced by fixed token rows (the driver under
    test is the overlap machinery, not GCPG sampling)."""
    def generate(model, pp_h, pp_e, pp_m, conds, **kw):
        if calls is not None:
            calls.append(kw["generator"])
        return torch.from_numpy(_token_rows(tok, pp_h.shape[0], smiles_of_row))
    return generate


def _cfg(**kw):
    base = dict(n_clouds_per_pocket=4, diff_timesteps=4, n_phar_max=4, cluster_counts=(2,),
                smiles_per_hypothesis=32, decode_batch=16, n_conformers=2, refine_steps=40,
                num_keep=2, align_chunk=8, size_bucket=8, contact_filter=None)
    base.update(kw)
    return run_all.PipelineConfig(**base)


def test_run_pipeline_end_to_end(tiny, monkeypatch, tmp_path):
    monkeypatch.setitem(run_all._CONSENSUS, "gmm", fixed_consensus)
    calls = []
    monkeypatch.setattr(run_all.gcpg_mod, "generate", _fake_generate(tiny["tok"], calls=calls))
    results, stats = run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"],
                                          tiny["pockets"], 7, _cfg())
    assert stats["pockets"] == 2
    assert stats["hypotheses"] == 2          # one per pocket
    assert stats["raw_smiles"] == 64
    assert stats["unique_smiles"] >= 1
    assert stats["matched"] >= 1
    assert stats["aligned"] == len(results) >= 1
    assert stats["aligned_mols_per_min"] > 0
    assert len(calls) == 4 and all(g is calls[0] for g in calls)  # the decoder's own
    for r in results:
        assert np.isfinite(r.rmsd)
        assert r.hypothesis in (0, 1)
        assert 1 <= len(r.conformers) <= 2
        assert r.conformers[0][1].shape == (mol_from_smiles(r.smiles).n_atoms, 3)
    seen = [(r.smiles, r.hypothesis) for r in results]
    assert len(seen) == len(set(seen))

    out = run_all.write_pipeline_results(results, tmp_path / "out")
    index = json.loads(out.read_text())
    assert len(index) == len(results)
    first = read_sdf(tmp_path / "out" / index[0]["file"])
    assert 1 <= len(first) <= 2


def test_downstream_failure_does_not_deadlock(tiny, monkeypatch):
    """A dying align stage drains its input queue so upstream put() never
    blocks on the bounded queue."""
    monkeypatch.setitem(run_all._CONSENSUS, "gmm", fixed_consensus)
    monkeypatch.setattr(run_all.gcpg_mod, "generate",
                        _fake_generate(tiny["tok"], lambda i: "CCO"))

    def boom(*a, **k):
        raise RuntimeError("align blew up")

    monkeypatch.setattr(run_all, "align_entries", boom)
    cfg = _cfg(smiles_per_hypothesis=16, align_chunk=2, queue_depth=1)
    raised = []

    def run():
        try:
            run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"], tiny["pockets"], 7, cfg)
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the driver deadlocked"
    assert len(raised) == 1 and "align blew up" in str(raised[0])


def test_run_pipeline_propagates_errors(tiny):
    cfg = _cfg(consensus_method="nope")
    with pytest.raises(KeyError):
        run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"], tiny["pockets"], 7, cfg)


def test_contact_filter_points():
    rng = np.random.RandomState(0)
    pocket = rng.randn(20, 3).astype(np.float32) * 5.0
    near = pocket[:4] + rng.randn(4, 3).astype(np.float32) * 0.5
    far = pocket[:3] + 100.0
    pts = np.concatenate([near, far])
    fams = ["A", "B", "C", "D", "X", "Y", "Z"]
    kept, kf, dropped = run_all.contact_filter_points(pts, fams, pocket, 6.0)
    assert dropped == 3
    assert kf == ["A", "B", "C", "D"]
    np.testing.assert_allclose(kept, near)
    kept2, kf2, d2 = run_all.contact_filter_points(near, fams[:4], pocket, 6.0)
    assert d2 == 0 and len(kept2) == 4
    jkept, jkf, jd = jrun_all.contact_filter_points(pts, fams, pocket, 6.0)
    np.testing.assert_array_equal(kept, jkept)
    assert (kf, dropped) == (jkf, jd)


def test_keep_top_match_ranks_and_reports(tiny, monkeypatch):
    monkeypatch.setitem(run_all._CONSENSUS, "gmm", fixed_consensus)
    pool = ["CCO", "OCCO", "CCOC", "CO", "CCO", "OCO", "CCCO", "CCO"]
    monkeypatch.setattr(run_all.gcpg_mod, "generate",
                        _fake_generate(tiny["tok"], lambda i: pool[i % len(pool)]))
    cfg = _cfg(keep_top_match_frac=0.5, match_workers=1)
    results, stats = run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"],
                                          tiny["pockets"], 7, cfg)
    assert stats["aligned"] >= 1
    assert stats["kept"] == len(results) == max(1, int(stats["aligned"] * 0.5))
    assert "match_score_all_aligned" in stats and "match_score_kept" in stats
    if stats["match_score_kept"] >= 0 and stats["match_score_all_aligned"] >= 0:
        assert stats["match_score_kept"] >= stats["match_score_all_aligned"]


def test_validity_gate_drops_bad_hypotheses(tiny, monkeypatch):
    """Hypothesis 0's probe is all invalid (dropped, nothing shipped);
    hypothesis 1's probe and batches are valid (shipped in full)."""
    monkeypatch.setitem(run_all._CONSENSUS, "gmm", fixed_consensus)
    calls = []
    rows = _fake_generate(tiny["tok"], lambda i: "CCO")
    bad = _fake_generate(tiny["tok"], lambda i: "C(")

    def generate(*a, **kw):
        calls.append(1)
        return (bad if len(calls) == 1 else rows)(*a, **kw)

    monkeypatch.setattr(run_all.gcpg_mod, "generate", generate)
    cfg = _cfg(validity_gate=0.5, validity_probe=8)
    collect = {}
    results, stats = run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"],
                                          tiny["pockets"], 7, cfg, collect=collect)
    assert stats["hypotheses"] == 2
    assert stats["gate_dropped"] == 1
    assert stats["gate_probe_smiles"] == 16
    assert stats["raw_smiles"] == 32
    assert stats["valid_smiles"] == 32
    assert all(r.hypothesis == 1 for r in results)
    pv = collect["probe_validity"]
    assert pv[0] == 0.0 and pv[1] == 1.0
    assert list(collect["hyp_validity"]) == [1]


def test_run_pipeline_counters_match_jax(tiny, monkeypatch):
    """Both drivers on the same fixed consensus and the same decoded rows:
    equal counters and aligned SMILES per hypothesis."""
    for mod in (run_all, jrun_all):
        monkeypatch.setitem(mod._CONSENSUS, "gmm", fixed_consensus)
    monkeypatch.setattr(run_all.gcpg_mod, "generate", _fake_generate(tiny["tok"]))

    def jax_generate(model, params, rng, pp_h, pp_e, pp_m, conds, **kw):
        return jnp.asarray(_token_rows(tiny["jtok"], pp_h.shape[0],
                                       lambda i: POOL[i % len(POOL)]).astype(np.int32))

    monkeypatch.setattr(jrun_all.gcpg_mod, "generate", jax_generate)
    cfg = _cfg()
    jcfg = jrun_all.PipelineConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    jcollect, collect = {}, {}
    jres, jstats = jrun_all.run_pipeline(
        tiny["jdiff"], tiny["diff_params"], tiny["jgcpg"], tiny["gparams"], tiny["jtok"],
        tiny["pockets"], jax.random.PRNGKey(7), jcfg, collect=jcollect)
    res, stats = run_all.run_pipeline(tiny["diff"], tiny["gcpg"], tiny["tok"],
                                      tiny["pockets"], 7, cfg, collect=collect)
    assert {k: stats[k] for k in STAT_KEYS} == {k: jstats[k] for k in STAT_KEYS}
    assert stats["aligned"] >= 1
    assert collect["uniq"] == jcollect["uniq"]
    for hid in (0, 1):
        assert ({r.smiles for r in res if r.hypothesis == hid}
                == {r.smiles for r in jres if r.hypothesis == hid})


GRAPH_SMILES = ["CCOc1ccccc1", "OC(=O)CCc1ccccc1N", "CN1CCN(CC1)c1ccc(cc1)NC(=O)c1ccc(O)cc1",
                "NC(=N)c1ccc(Cl)cc1", "CC(C)(C)OC(=O)NCCc1c[nH]cn1", "CCO", "C1CC"]


def test_ppgraph_and_match_scores_equal_jax():
    """smiles_to_ppgraph on the same random.Random seeds, match_score and
    get_match_scores(n_workers=1) equal to the JAX package's."""
    import random

    graphs = []
    for i, s in enumerate(GRAPH_SMILES):
        out = ppgraph.smiles_to_ppgraph(s, random.Random(i))
        ref = jppgraph.smiles_to_ppgraph(s, random.Random(i))
        if ref is None:
            assert out is None
            continue
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        graphs.append(out[:3])
    pairs = [(g, s) for g in graphs for s in GRAPH_SMILES]
    scores = [match.match_score(s, *g) for g, s in pairs]
    assert scores == [jmatch.match_score(s, *g) for g, s in pairs]
    assert -1.0 in scores and max(scores) == 1.0
    batch = match.get_match_scores([g for g, _ in pairs], [s for _, s in pairs], n_workers=1)
    assert batch == jmatch.get_match_scores([g for g, _ in pairs], [s for _, s in pairs],
                                            n_workers=1) == scores


def test_native_bond_distances_equal_python_bfs(monkeypatch):
    assert native.get_lib() is not None, "g++ builds the native library here"
    mols = [mol_from_smiles(s) for s in GRAPH_SMILES[:-1]] + [mol_from_smiles("CC.OC")]
    built = [native.all_pairs_bond_dist(m) for m in mols]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for m, d in zip(mols, built):
        ref = native.all_pairs_bond_dist(m)
        # the library sums a path in float32, the fallback in Python floats
        # rounded once: equal up to float32 rounding of the sum
        np.testing.assert_allclose(d, ref, rtol=4 * np.finfo(np.float32).eps, atol=0)
        assert d.shape == (m.n_atoms, m.n_atoms)
    assert built[-1][0, 2] == 100.0  # disconnected
