"""The committed dry-run results of the port, ``results/dryrun_torch.json``
(the twin of tests/test_dryrun_results.py, which reads the JAX package's
``results/dryrun.json``): every (arch x shape x mesh) cell was costed,
with coherent roofline terms. The file is made by
``python -m repro_torch.launch.dryrun`` on any CPU (no device); a missing
file fails here rather than skipping."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch import roofline

torch.set_num_threads(1)  # see test_torch_spmm.py

RESULTS = Path(__file__).resolve().parent.parent / "results" / "dryrun_torch.json"
LM_ARCHS = [a for a in ARCH_IDS if a != "gnn_sage"]


@pytest.fixture(scope="module")
def results():
    assert RESULTS.exists(), f"{RESULTS} is missing: run python -m repro_torch.launch.dryrun"
    return json.loads(RESULTS.read_text())


def test_all_cells_costed(results):
    missing, failed = [], []
    for arch in LM_ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                key = f"{arch}|{shape}|{mesh}"
                if key not in results:
                    missing.append(key)
                elif not results[key].get("ok"):
                    failed.append(key)
    assert not missing, missing
    assert not failed, failed
    assert len(results) == len(LM_ARCHS) * len(SHAPES) * 2 == 80


def test_roofline_terms_coherent(results):
    for key, cell in results.items():
        r = cell["roofline"]
        assert r["compute_s"] >= 0 and r["memory_s"] > 0, key
        assert r["bottleneck"] in ("compute", "memory", "collective"), key
        assert r["compute_s"] == pytest.approx(r["flops"] / roofline.PEAK_FLOPS), key
        assert r["memory_s"] == pytest.approx(r["hbm_bytes"] / roofline.HBM_BW), key
        assert r["collective_s"] == pytest.approx(
            sum(r["coll_bytes"].values()) / roofline.LINK_BW), key
        terms = {"compute": r["compute_s"], "memory": r["memory_s"],
                 "collective": r["collective_s"]}
        assert r["bottleneck"] == max(terms, key=terms.get), key
        mem = cell["memory"]
        assert min(mem.values()) >= 0 and mem["argument_size_in_bytes"] > 0, key
        assert cell["useful_flops_ratio"] == pytest.approx(
            cell["model_flops_total"] / (r["flops"] * cell["n_devices"])), key


def test_multi_pod_compute_does_not_grow(results):
    """Multi-pod runs the same global problem on twice the ranks: a
    per-rank compute term above 1e-4 s must not exceed single-pod's."""
    for arch_shape in {k.rsplit("|", 1)[0] for k in results}:
        s = results[arch_shape + "|single"]
        m = results[arch_shape + "|multi"]
        if s["roofline"]["compute_s"] > 1e-4:
            assert m["roofline"]["compute_s"] <= s["roofline"]["compute_s"] * 1.05, arch_shape


@pytest.mark.parametrize("mesh, n", [("multi", 512), ("single", 256)])
def test_device_counts(results, mesh, n):
    cells = [v for k, v in results.items() if k.endswith(f"|{mesh}")]
    assert len(cells) == 40
    assert all(v["n_devices"] == n for v in cells)
    assert all(v["mesh"] == ("2x16x16" if n == 512 else "16x16") for v in cells)
