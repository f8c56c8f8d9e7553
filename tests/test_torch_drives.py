"""The drives at a tiny size on the CPU: ``drives.churn`` (N 4,000 × D 32,
64 queries) prints one JSON line a phase with its keys, no removed id comes
back and every re-added row finds itself; ``drives.serve_load`` (tiny-test,
200 documents, phases A and D of 0.5 s, retrieve_k 4) answers every
request and reports queries/s, p50 / p95 and the server's ``/metrics``.
Neither times a window twice: every churn rate comes with its windows."""

import json

import numpy as np
import torch

from text_similarity_tpu_torch.drives import churn, serve_load
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CHURN_KEYS = {
    "fresh": {"rows", "build_seconds", "clusters", "overflow", "qps_windows", "qps_median",
              "recall_at_10"},
    "remove": {"rows", "seconds", "rows_per_s", "snapshot_save_seconds"},
    "add": {"batching", "rows", "seconds", "rows_per_s", "snapshot_load_seconds"},
    "post_churn": {"qps_windows", "qps_median", "recall_at_10", "recall_drop_vs_fresh"},
    "tombstone_leak_check": {"leaked"},
    "readd_self_check": {"rows", "found_top10", "found_first"},
    "rebuild": {"build_seconds", "qps_windows", "qps_median", "recall_at_10"},
}


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_churn_drive_at_a_tiny_size(capsys, tmp_path):
    rows = churn.main(["--n", "4000", "--d", "32", "--queries", "64",
                       "--snapshot-dir", str(tmp_path), "--device", "cpu"])
    lines = _lines(capsys)
    assert [r["phase"] for r in lines] == ["fresh", "remove", "add", "add", "post_churn",
                                           "tombstone_leak_check", "readd_self_check", "rebuild"]
    for r in lines:
        assert set(r) == CHURN_KEYS[r["phase"]] | {"phase"}, r["phase"]
        if "qps_windows" in r:
            assert len(r["qps_windows"]) == 5 and r["qps_median"] == float(
                np.median(r["qps_windows"]))
    assert [r["batching"] for r in lines if r["phase"] == "add"] == ["1x400", "10x40"]
    assert rows["remove"]["rows"] == 400 and rows["tombstone_leak_check"]["leaked"] == 0
    readd = rows["readd_self_check"]
    assert readd["found_top10"] == readd["found_first"] == readd["rows"] == 400
    assert list(tmp_path.iterdir()) == []          # the snapshot is deleted


def test_churn_data_follows_the_bench_recipe():
    """Unit rows; the new rows come from the corpus's own centres (each
    near one of them, as the corpus rows are)."""
    corpus, queries = churn.bench_corpus(500, 16, 32, seed=1, device="cpu")
    added = churn.new_rows(100, 32, seed=1, device="cpu")
    centers = churn._centers(32, 1, "cpu")
    for x in (corpus, queries, added):
        torch.testing.assert_close(x.norm(dim=1), torch.ones(x.shape[0]))
    best = (torch.nn.functional.normalize(centers, dim=1) @ added.T).amax(dim=0)
    assert float(best.min()) > 0.8
    assert torch.equal(churn.bench_corpus(500, 16, 32, seed=1, device="cpu")[0], corpus)


def test_serve_load_drive_at_a_tiny_size(capsys):
    rows = serve_load.main(["--n-docs", "200", "--duration", "0.5", "--phases", "AD",
                            "--arch", "tiny-test", "--fp32", "--rerank-factor", "1",
                            "--retrieve-k", "4", "--device", "cpu"])
    lines = _lines(capsys)
    assert [r["phase"] for r in lines] == ["A_search_b1_microbatch", "D_rerank_b256_k4"]
    assert lines == json.loads(json.dumps(rows))
    for r in lines:
        assert set(r) == {"phase", "path", "batch", "clients", "requests", "errors", "seconds",
                          "queries_per_s", "p50_ms", "p95_ms", "metrics"}
        assert r["errors"] == 0 and r["requests"] > 0 and r["p50_ms"] <= r["p95_ms"]
        stats = r["metrics"][r["path"]]
        assert stats["errors"] == 0 and stats["requests"] >= r["requests"]
