"""The port's examples (``examples/torch_*.py``) on the CPU against the
reference package.

Each example runs through its ``main([... "--device", "cpu"])`` at
``tpch.generate(0.005, seed=11)``; the results it returns must equal the
reference's ``run_reference`` on the same generated data (integer columns
exactly, floats within rtol 1e-7), and what the planner reports (static
counts, explanations, wire bytes) must equal the reference planner's.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import backend as RB
from repro.data import tpch as ref_tpch
from repro.queries import QUERIES as REF_QUERIES

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--sf", "0.005", "--seed", "11", "--device", "cpu"]
EXAMPLES = ("quickstart", "plan_quickstart", "sql_quickstart",
            "groupby_paths", "analytics_distributed", "serve_lm", "train_lm")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name: str):
    return _load(ROOT / "examples" / f"torch_{name}.py", f"torch_{name}")


@pytest.fixture(scope="module")
def ref_db():
    return ref_tpch.generate(0.005, seed=11)


def assert_equal_result(got: dict, want: dict, label: str = "") -> None:
    """Same columns and rows; integers exactly, floats within rtol 1e-7."""
    assert sorted(got) == sorted(want), label
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, f"{label} {k}"
        if np.issubdtype(b.dtype, np.floating) or \
                np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=1e-7,
                                       err_msg=f"{label} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")


def test_quickstart(ref_db):
    out = example("quickstart").main(CPU)
    assert out["rows"] == {n: len(next(iter(t.values())))
                           for n, t in ref_db.tables.items()}
    for qid in (1, 6, 19):
        want, stats = RB.run_reference(REF_QUERIES[qid], ref_db)
        assert_equal_result(out["results"][qid], want, f"q{qid}")
        assert out["counts"][qid] == stats.counts()
    assert out["q1_flags"] == ["A", "N", "N", "R"]


def test_plan_quickstart(ref_db):
    from repro.core.planner import compile_query
    ref = _load(ROOT / "examples" / "plan_quickstart.py", "ref_plan_qs")
    ref_q6 = compile_query(ref.q6_plan, name="q6")
    out = example("plan_quickstart").main(CPU)
    want, _ = RB.run_reference(ref_q6, ref_db)
    np.testing.assert_allclose(out["revenue_local"],
                               float(want["revenue"][0]), rtol=1e-7)
    assert out["revenue_reference"] == float(want["revenue"][0])
    assert out["allreduces"] == 1
    assert out["static_counts"] == ref_q6.static_counts()
    assert out["notes"] == ref_q6.validate(ref_db) == []
    assert out["explain_q6"] == ref_q6.explain(ref_db)
    assert out["explain_q1"] == REF_QUERIES[1].explain(ref_db)
    assert_equal_result(out["q1"], RB.run_reference(REF_QUERIES[1],
                                                    ref_db)[0], "q1")


def test_sql_quickstart(ref_db):
    from repro.sql import compile_sql, parse
    from repro.sql.ast import format_query
    mod = example("sql_quickstart")
    out = mod.main(CPU)
    q = compile_sql(mod.SQL, name="supplier_balance")
    want, stats = RB.run_reference(q, ref_db)
    assert out["canonical"] == format_query(parse(mod.SQL))
    assert out["static_counts"] == q.static_counts() == stats.counts()
    assert out["wire"] == q.static_wire(ref_db)
    assert_equal_result(out["local"], want, "local")
    assert_equal_result(out["reference"], want, "reference")


def test_groupby_paths(ref_db):
    import jax
    from repro.core import relational as R
    from repro.core.table import from_numpy, to_numpy
    mod = example("groupby_paths")
    out = mod.main(CPU)
    # the sort counts: one stable argsort on the sort path, none elsewhere
    assert out["sorts"] == {"sort": 1, "direct": 0, "hash": 0}
    # the same table through the reference's sort path
    rng = np.random.default_rng(7)
    domain = rng.integers(0, 1 << 40, 64).astype(np.int64)
    keys = domain[rng.integers(0, 64, 1000)]
    vals = rng.normal(size=1000)
    with jax.default_device(jax.devices("cpu")[0]):
        want = to_numpy(R.group_aggregate(
            from_numpy({"k": keys, "v": vals}, capacity=1024), ["k"],
            mod.AGGS, method="sort"))
    for path in ("sort", "hash"):
        assert_equal_result(out["results"][path], want, path)
    np.testing.assert_array_equal(out["results"]["direct"]["rows"],
                                  want["rows"])
    for qid in (12, 13):
        assert out["explain"][qid] == REF_QUERIES[qid].explain(ref_db)


@pytest.fixture(scope="module")
def distributed():
    return example("analytics_distributed").main(CPU)


@pytest.mark.parametrize("qid", sorted(REF_QUERIES))
def test_analytics_distributed(distributed, ref_db, qid):
    got = distributed[qid]
    want, _ = RB.run_reference(REF_QUERIES[qid], ref_db)
    assert_equal_result(got["result"], want, f"q{qid}")
    counts = REF_QUERIES[qid].static_counts()
    assert (got["shuffles"], got["broadcasts"]) == \
        (counts["shuffles"], counts["broadcasts"])
    assert got["attempts"] == 1
    assert got["rows"] == len(next(iter(want.values())))


def test_serve_lm():
    mod = example("serve_lm")
    args = ["--batch", "2", "--prompt-len", "8", "--tokens", "4",
            "--device", "cpu"]
    out = mod.main(args)
    assert out["arch"] == "rwkv6-3b"
    assert out["tokens"].shape == (2, 4)
    # the first token is the greedy pick after the prompt: forward's argmax
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    model = Model(get_config("rwkv6_3b").reduced(), device="cpu",
                  dtype=torch.float32, expert_pad=1,
                  generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        logits = model(torch.from_numpy(out["prompts"]))
    np.testing.assert_array_equal(out["tokens"][:, 0],
                                  logits[:, -1].argmax(-1).numpy())
    # seeded: the same tokens again
    np.testing.assert_array_equal(mod.main(args)["tokens"], out["tokens"])


def test_train_lm_batches_are_the_references():
    """``synthetic_batch`` draws the reference's zipf stream byte for
    byte."""
    ref = _load(ROOT / "examples" / "train_lm.py", "train_lm")
    port = example("train_lm")
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for shape in ((8, 128), (2, 16), (3, 5)):
        want = ref.synthetic_batch(a, 512, *shape)
        got = port.synthetic_batch(b, 512, *shape)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert got[k].numpy().tobytes() == \
                np.asarray(want[k]).tobytes(), (k, shape)


def test_train_lm(tmp_path, capsys):
    """Step 1's loss is ``Model.loss`` of the seeded model on the first
    batch; a rerun into the same directory restores the checkpoint and
    goes on from the next step."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    mod = example("train_lm")
    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    losses = mod.main(args)
    assert sorted(losses) == [1]
    cfg = get_config("mistral_nemo_12b").reduced()
    model = Model(cfg, device="cpu", dtype=torch.float32, expert_pad=1,
                  generator=torch.Generator().manual_seed(0))
    batch = mod.synthetic_batch(np.random.default_rng(0), cfg.vocab, 2, 16)
    with torch.no_grad():
        want, _ = model.loss(batch["tokens"], batch["labels"])
    assert losses[1] == pytest.approx(float(want), rel=1e-6)
    again = mod.main(args[:1] + ["12"] + args[2:])
    assert sorted(again) == [4, 10]
    out = capsys.readouterr().out
    assert "restored from step 3" in out and "step    4  loss=" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_is_cuda_and_raises_without_it(name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example(name).main([])
