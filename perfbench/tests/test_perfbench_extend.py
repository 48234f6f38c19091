"""A new traffic mix and a new cell come as a new file and a new entry,
with no edit to a file the benchmark has."""
import json
import shutil

from perfbench.tests import smoke


def test_throwaway_mix_needs_no_edit(tmp_path):
    shutil.copytree(smoke.DATA, tmp_path, dirs_exist_ok=True)
    mix = json.loads((smoke.DATA / "traffic" / "tiny_backlog.json").read_text())
    mix.update(prompt_len=48, gen_len=5, kv_frames=4 * 5, check_requests=1)
    (tmp_path / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    cell = {"name": "relu2.throwaway", "config": "smoke_relu2",
            "traffic": "throwaway", "chips": 1, "why": "test"}
    r = smoke.run("relu2.throwaway", data=tmp_path, extra=[cell])
    assert r["correct"], r["checks"]
    assert {"tok_per_s", "itl_p95_ms", "setup_s"} == set(r["metrics"])
    assert r["compared_tokens"] == 5
