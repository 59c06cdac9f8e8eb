"""The port's ``warmup`` command on the CPU: its options and defaults are
the JAX command's, an unknown pipeline gives exit 1 naming it, and each
requested pipeline prints one ``warm`` line (tests/test_cli.py's warmup
cases, with ``--device cpu``)."""

import pytest

from aegis_tpu import __main__ as jax_cli
from aegis_tpu_torch import __main__ as cli


def _parsed(module, argv, monkeypatch) -> dict:
    """The arguments ``module.main(argv)`` hands its warmup command."""
    seen = {}

    def capture(args):
        seen.update(vars(args))
        return 0

    monkeypatch.setattr(module, "cmd_warmup", capture)
    assert module.main(["warmup", *argv]) == 0
    return {k: v for k, v in seen.items() if k not in ("fn", "device")}


@pytest.mark.parametrize("argv", [
    [], ["--sr", "44100", "--seconds", "30,60", "--pipelines", "poly,live-v1"],
    ["--pipelines", "neural-stream"]])
def test_warmup_parses_as_the_jax_command(argv, monkeypatch):
    assert _parsed(cli, argv, monkeypatch) == _parsed(jax_cli, argv,
                                                      monkeypatch)
    assert _parsed(cli, argv + ["--device", "cpu"], monkeypatch) == _parsed(
        cli, argv, monkeypatch)


def test_warmup_pipelines_are_the_jax_commands(capsys):
    """The pipelines the JAX command's --pipelines help lists, in order."""
    import re
    with pytest.raises(SystemExit):
        jax_cli.main(["warmup", "--help"])
    # argparse wraps the list at its hyphens
    text = re.sub(r"-\n\s+", "-", capsys.readouterr().out)
    listed = re.search(r"comma-separated: ([\w,-]+)", text).group(1)
    assert tuple(listed.split(",")) == cli.WARM_PIPELINES


def test_warmup_rejects_unknown_pipeline(capsys):
    assert cli.main(["warmup", "--pipelines", "v1,nonsense"]) == 1
    assert "nonsense" in capsys.readouterr().err
    with pytest.raises(ValueError, match="nonsense"):
        cli.warmup(["nonsense"], [0.5], device="cpu")


def test_warmup_runs_each_pipeline_on_the_cpu(capsys):
    pipes = ["v1", "poly", "live-v1", "live-financial", "live-poly"]
    assert cli.main(["warmup", "--device", "cpu", "--seconds", "0.5",
                     "--pipelines", ",".join(pipes)]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("warm ")]
    assert len(lines) == len(pipes)
    for pipe, line in zip(pipes, lines):
        assert line.split()[1] == pipe and "@ 0.5s/22050Hz:" in line, line
