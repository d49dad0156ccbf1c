"""The port's launchers in their fleet modes, on the CPU: the
``serve_trace`` script passes the repository's cluster, chaos, network,
partition and metrics smoke command lines with ``--device cpu --tiny``,
its gates fail a run whose audit fails, and ``repro_torch.launch.serve
--sim`` prints what ``repro.launch.serve --sim`` prints for the same
arguments."""
import pytest

pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve, serve_trace  # noqa: E402

CPU = ["--device", "cpu", "--tiny", "--arch", "qwen3-8b"]
SMOKES = {
    "fleet": "-n 8 --cluster 2 --router least-kvc",
    "disagg": "-n 8 --cluster 2 --disagg",
    "kill": "-n 10 --cluster 3 --chaos kill@25:1",
    "squeeze": ("-n 10 --cluster 2 --kvc-tokens 192 "
                "--chaos squeeze@10:0/0.5,squeeze@10:1/0.5"),
    "detected-kill": ("-n 10 --cluster 3 --detect "
                      "--chaos drop@6:1/0.6,dup@14:2/0.6,kill@25:0"),
    "hedge-partition": ("-n 10 --cluster 3 --detect --hedge "
                        "--chaos slow@2:1/40x6,part@6:2|0/12"),
    "metrics": "-n 10 --cluster 2 --chaos kill@25:1 --metrics",
}


@pytest.mark.parametrize("name", list(SMOKES))
def test_serve_trace_passes_the_smoke(name, tmp_path, capsys):
    argv = CPU + SMOKES[name].split()
    if name == "metrics":
        argv.append(str(tmp_path / "m"))
    assert serve_trace.main(argv) == 0
    out = capsys.readouterr().out
    if "--chaos" in argv:
        assert "invariants_ok=True tokens_equal=True" in out
    if name == "metrics":
        prom = (tmp_path / "m.prom").read_text()
        for fam in ("engine_kvc_occupied_blocks{", "scheduler_queue_depth{",
                    "engine_host_syncs_total{", "fleet_instance_health{"):
            assert any(line.startswith(fam) for line in prom.splitlines())


def test_serve_trace_fails_when_the_audit_fails(monkeypatch, capsys):
    def failing(fleet, strict=True):
        return {"ok": False, "problems": ["injected"]}
    monkeypatch.setattr(serve_trace, "check_fleet_invariants", failing)
    assert serve_trace.main(CPU + SMOKES["kill"].split()) == 1
    assert "invariant problems: ['injected']" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    "--sim --arch opt-13b --trace sharegpt --requests 120 --rate 5.0",
    "--sim --arch qwen3-8b --trace sharegpt --requests 120 --rate 5.0 "
    "--scheduler vllm",
    "--sim --arch opt-13b --trace sharegpt --requests 120 --rate 5.0 "
    "--cluster 3 --router least-kvc --disagg",
], ids=["single", "vllm", "cluster-disagg"])
def test_serve_sim_prints_the_reference_lines(argv, capsys):
    assert jserve.main(argv.split()) == 0
    want = capsys.readouterr().out
    assert serve.main(argv.split()) == 0
    assert capsys.readouterr().out == want and want


def test_serve_cluster_mode_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--cluster", "2", "--disagg",
                       "--requests", "4", "--capacity", "128"]) == 0
    out = capsys.readouterr().out
    assert "served 4/4" in out and "'ok': 1" in out
