"""The result line holds exactly the keys of the result format, the compared numbers
last; without a card the command exits non-zero and prints no result; JAX
loaded in the process is found by whole top-level names."""

import sys

from small import small_files

from portbench import run


def test_result_keys():
    files = small_files("bricks8.scan")
    result, nums, ctrl = run.run_cell(files, 77, 0.2, False, "cpu", 0.0)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in files["end_to_end"]}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for name, c in result["checked"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], name
    assert set(files["limits"]["limits"]) <= set(nums) and ctrl is None


def test_no_card_no_result(capsys):
    assert run.main(["--workload", "bricks8.scan", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "cpu_tsdf_tpu_torchlike", object())
    found = run.forbidden_modules()
    assert "jax.numpy" in found and "cpu_tsdf_tpu_torchlike" not in found
    assert not any(n.startswith("cpu_tsdf_tpu_torch") for n in found)
