"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
the CPU (``--device cpu``, the reduced granite config): every backend
serves, writes a trace the port's cost model folds and prints the
reference launcher's summary lines; the two-step streaming cold start;
a fault plan given as a JSON string; expert parallelism refused with its
queue item named; and no quiet fallback to the CPU without ``--device``."""
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve
from repro_torch.obs import costmodel, load_chrome_trace

SMALL = ["--batch", "2", "--prompt-len", "16", "--new-tokens", "4",
         "--device", "cpu"]

#: The reference launcher's summary lines (``src/repro/launch/serve.py``),
#: as patterns, in order; the spec line only with speculation on.
LINES = {
    "head": r"\[serve\] \S+ backend=\w+ device=cpu spec_k=\d+ ep_shards=1$",
    "ttft": r"\[serve\] TTFT [\d.]+ ms  TPOT [\d.]+ ms  throughput "
            r"[\d.]+ tok/s$",
    "dispatch": r"\[serve\] moe dispatch=(ragged|padded): active_experts "
                r"[\d.]+/\d+  pad_ratio [\d.]+$",
    "spec": r"\[serve\] spec: accept_rate [\d.]+  tokens/row-round [\d.]+ "
            r"\(1\.0 = no speculation; \d+ drafted over \d+ rounds\)$",
    "bytes": r"\[serve\] resident expert bytes: [\d,]+$",
    "obs": r"\[serve\] obs: \d+ events \(\d+ dropped\)  promotions \d+ "
           r"published / \d+ cancelled publish p95 [\d.]+ ms  bytes/token "
           r"residual max [\d.]+ over \d+ decode steps  stall exposure "
           r"[\d.]+ ms  shed \d+$",
    "trace": r"\[serve\] trace -> \S+$",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _check_lines(lines, spec=True, trace=True):
    want = [k for k in LINES if (spec or k != "spec") and
            (trace or k != "trace")]
    assert len(lines) == len(want), lines
    for key, line in zip(want, lines):
        assert re.match(LINES[key], line), (key, line)


@pytest.mark.parametrize("backend", ["dynaexq", "static", "fp16", "offload"])
def test_launcher_serves_each_backend(tmp_path, backend):
    trace = str(tmp_path / "t.json")
    rows = str(tmp_path / "m.jsonl")
    out = serve.main(["--backend", backend, "--trace-out", trace,
                      "--metrics-jsonl", rows] + SMALL)
    _check_lines(out["lines"])
    assert all(len(t) == 4 for t in out["tokens"])
    obj = load_chrome_trace(trace)
    assert obj["otherData"]["backend"] == backend
    rep = costmodel.report(trace)
    assert rep["roofline"]["n_steps"] > 0
    assert rep["roofline"] == out["obs"]["roofline"]
    steps = [e for e in obj["traceEvents"] if e["name"] == "step"]
    sampled = [json.loads(ln) for ln in open(rows)]
    assert [r["step"] for r in sampled] == [e["args"]["step"] for e in steps]
    assert out["stats"]["finished"] == 2.0


def test_launcher_without_obs_prints_the_stats_line():
    out = serve.main(["--backend", "static", "--no-obs", "--no-spec"] +
                     SMALL)
    assert out["obs"] is None
    assert out["lines"][-1].startswith("[serve] uniform stats: {")
    assert len(out["lines"]) == 5


def test_two_step_streaming_cold_start(tmp_path):
    shards = str(tmp_path / "shards")
    hot = str(tmp_path / "hot")
    out = serve.main(["--backend", "dynaexq", "--save-shards", shards] +
                     SMALL)
    assert out["lines"][-1] == f"[serve] expert-sharded checkpoint -> " \
                               f"{shards}"
    assert os.path.exists(os.path.join(shards, "manifest.json"))
    out = serve.main(["--backend", "dynaexq", "--stream-from", shards,
                      "--lo-resident-total", "6", "--hotness-path", hot,
                      "--no-spec"] + SMALL)
    st = out["stats"]
    # 2 layers x 4 experts, 6 cells lo-resident: the rest on the host tier.
    assert st["lo_resident_frac"] == 0.75
    assert st["residency_ready_frac"] == 1.0
    assert out["lines"][-1] == f"[serve] hotness snapshot -> {hot}_p*.npz"
    assert os.path.exists(f"{hot}_p0.npz")
    _check_lines(out["lines"][:-1], spec=False, trace=False)
    # The second cold start stages hottest-first from the snapshot.
    out = serve.main(["--backend", "dynaexq", "--stream-from", shards,
                      "--lo-resident-total", "6", "--hotness-path", hot,
                      "--no-spec"] + SMALL)
    assert all(len(t) == 4 for t in out["tokens"])


def test_fault_plan_as_a_json_string(tmp_path):
    shards = str(tmp_path / "shards")
    serve.main(["--backend", "dynaexq", "--save-shards", shards] + SMALL)
    trace = str(tmp_path / "t.json")
    plan = '{"seed": 7, "rules": [{"site": "host_lo", "every": 2}]}'
    out = serve.main(["--backend", "dynaexq", "--stream-from", shards,
                      "--fault-plan", plan, "--fault-seed", "3",
                      "--no-spec", "--trace-out", trace] + SMALL)
    assert out["stats"]["retries"] > 0
    assert out["stats"]["quarantined"] == 0.0
    events = load_chrome_trace(trace)["traceEvents"]
    fired = [e for e in events if e["name"] == "fault_injected"]
    assert fired and all(e["args"]["site"] == "host_lo" for e in fired)
    assert any(e["name"] == "retry" for e in events)
    assert all(len(t) == 4 for t in out["tokens"])


def test_expert_parallelism_exits_naming_its_queue_item():
    with pytest.raises(SystemExit, match="Queue 1, item 7"):
        serve.main(["--ep-shards", "2"] + SMALL)


def test_launcher_without_device_raises_on_a_cpu_host():
    """The default device is the card: without one the launcher raises
    instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(SMALL[:-2])


def test_launcher_runs_as_a_module(tmp_path):
    """``python -m repro_torch.launch.serve`` from a shell."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--backend", "static", "--no-spec"] + SMALL,
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    _check_lines(r.stdout.strip().splitlines(), spec=False, trace=False)
