"""``python -m vitxtgqa_tpu_torch.serve`` (the port's tools/serve.py) on
the CPU: concurrent clients against the serving engine at a tiny width,
every response held to its group's direct forward, the JSON report's keys
and the env knobs against the JAX tool's."""

import ast
import importlib.util
import os
import threading

import numpy as np
import pytest
import torch

from tests.torch_helpers import one_torch_thread  # noqa: F401
from vitxtgqa_tpu_torch import serve as S
from vitxtgqa_tpu_torch.serving.engine import ServingEngine, group_generator, to_device
from vitxtgqa_tpu_torch.utils.synthetic import tiny_model_config

FRAMES, OPF = 8, 3
NF = 32 + FRAMES * OPF
BATCH_KW = dict(frames=FRAMES, ocr_per_frame=OPF, dec_steps=4, text_len=10, video_feat_dim=32,
                fasttext_dim=16, phoc_dim=24, text_vocab=128)
KNOBS = S.Knobs(buckets=(2, 4), wait_ms=5.0, clients=4, requests=24, rps=200.0)


def jax_tool(repo_root, monkeypatch, env):
    """tools/serve.py loaded under ``env`` (its knobs are read at import)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("jax_serve_tool",
                                                  os.path.join(repo_root, "tools", "serve.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def jax_report_keys(repo_root):
    """The keys of the JSON line tools/serve.py prints."""
    with open(os.path.join(repo_root, "tools", "serve.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return sorted(k.value for k in node.args[0].keys)
    raise AssertionError("no json.dumps({...}) in tools/serve.py")


@pytest.fixture(scope="module")
def served():
    """serve() on the CPU with the forwards recorded: (the group id, the
    padded batch, the model) of each engine step."""
    steps, lock = [], threading.Lock()
    real = ServingEngine.step

    def recording(self, batch, group_id):
        with lock:
            steps.append((group_id, {k: v.copy() for k, v in batch.items()}, self.model))
        return real(self, batch, group_id)

    ServingEngine.step = recording
    try:
        report, details = S.serve(tiny_model_config(frames=FRAMES, ocr_per_frame=OPF),
                                  device="cpu", knobs=KNOBS, num_final_outputs=NF,
                                  batch_kw=BATCH_KW)
    finally:
        ServingEngine.step = real
    return report, details, steps


def test_every_response_is_its_row_of_its_groups_forward(served):
    """Each of the 24 responses equals, bit for bit, the row of a direct
    forward of its group's padded batch (the group's gumbel generator)
    that holds its request, each real row of each group answering one
    request; the group sizes add up to the requests, none above the
    largest bucket."""
    report, details, steps = served
    responses, sizes = details["responses"], details["group_sizes"]
    groups = [(gid, b, m) for gid, b, m in steps if gid >= 0]  # not the warm-up
    assert len(responses) == KNOBS.requests == sum(sizes)
    assert len(groups) == len(sizes) == report["groups"] and max(sizes) <= max(KNOBS.buckets)
    cpu = torch.device("cpu")
    rows = []  # (group, row, the request's sample, its outputs)
    for (gid, batch, model), n in zip(sorted(groups, key=lambda g: g[0]), sizes):
        assert next(iter(batch.values())).shape[0] in KNOBS.buckets
        with torch.inference_mode():
            out = model(to_device(batch, cpu), group_generator(0, gid, cpu))
        rows += [(gid, i, {k: v[i] for k, v in batch.items()},
                  {k: out[k][i].numpy() for k in ("pos_scores", "ground_frame", "ground_box")})
                 for i in range(n)]
    pool = S.synthetic_batch(batch=S.POOL, num_final_outputs=NF, seed=0, **BATCH_KW)
    for _, index, got in responses:
        assert got["pos_scores"].shape == (4, NF) and np.isfinite(got["pos_scores"]).all()
        match = [r for r in rows if all(np.array_equal(r[2][k], pool[k][index]) for k in pool)
                 and all(np.array_equal(got[k], r[3][k]) for k in r[3])]
        assert match, f"no row of any group's forward answers request {index} so"
        rows.remove(match[0])
    assert not rows


def test_report_has_the_jax_tools_keys_and_the_device(served, repo_root):
    report, details, _ = served
    assert sorted(report) == sorted(jax_report_keys(repo_root) + ["device"])
    assert report["metric"] == "t2s_serving_engine_demo" and report["device"] == "cpu"
    assert report["requests"] == KNOBS.requests and report["clients"] == KNOBS.clients
    assert report["buckets"] == [2, 4] and report["throughput_rps"] > 0
    lat = report["latency_ms"]
    assert sorted(lat) == ["p50", "p90", "p99"] and 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    assert details["h2d_share"] is None and details["h2d_ms"] == []


@pytest.mark.parametrize("env", [
    {}, {"SERVE_BUCKETS": "2,4,16", "SERVE_WAIT_MS": "7.5", "SERVE_CLIENTS": "3",
         "SERVE_REQUESTS": "12", "SERVE_RPS": "20", "BENCH_KV_INT8": "0", "BENCH_COMPACT": "1",
         "BENCH_PALLAS": "0"}], ids=["defaults", "set"])
def test_knobs_parse_as_the_jax_tools(env, repo_root, monkeypatch):
    """SERVE_* as tools/serve.py's module constants; BENCH_* as its main()
    reads them (on when "1")."""
    tool = jax_tool(repo_root, monkeypatch, env)
    knobs = S.Knobs.from_env(os.environ)
    assert (list(knobs.buckets), knobs.wait_ms, knobs.clients, knobs.requests, knobs.rps) == (
        tool.BUCKETS, tool.WAIT_MS, tool.CLIENTS, tool.REQUESTS, tool.RPS)
    assert (knobs.kv_cache_int8, knobs.compact_serving, knobs.kernels) == tuple(
        os.environ.get(k, d) == "1"
        for k, d in (("BENCH_KV_INT8", "1"), ("BENCH_COMPACT", "0"), ("BENCH_PALLAS", "1")))
    if not env:
        assert knobs == S.Knobs()


def test_serve_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without CUDA serve() raises; on the card BENCH_PALLAS=0 raises (the
    plain versions never serve there)."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.serve(knobs=KNOBS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="BENCH_PALLAS=0"):
        S.serve(knobs=S.Knobs(kernels=False))
