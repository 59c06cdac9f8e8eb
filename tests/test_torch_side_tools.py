"""The port's side tools against the JAX package's, on the CPU: the copies
of ``tools/collectors.py`` and ``tools/minify_html.py``, ``make_golden``'s
clips, and the port's ``bench_table``, which cites only artifacts measured
on an NVIDIA card and owns only its own README markers."""

import json
import re
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from aegis_tpu.tools import bench_table as jbench_table
from aegis_tpu.tools import collectors as jcollectors
from aegis_tpu.tools import make_golden as jmake_golden
from aegis_tpu.tools import minify_html as jminify

from aegis_tpu_torch.tools import bench_table
from aegis_tpu_torch.tools import collectors
from aegis_tpu_torch.tools import make_golden
from aegis_tpu_torch.tools import minify_html

REPO = Path(__file__).resolve().parents[1]
JAX_BLOCK = re.compile(r"<!-- BENCH_TABLE_START.*?BENCH_TABLE_END -->", re.S)
TITLES = ["Song (Official Video) [HD]!", "  Foo   Bar  ", "", "Café — Live!",
          "a" * 300, "Great Song (Live at Venue)", "x_y-z", "ＦＵＬＬ width"]


def test_collectors_copy_equals_its_original(tmp_path):
    """Title keys, blocklist, dedup keys, configs and the ZIP of a folder
    as the original's; without yt_dlp both search and download are off."""
    assert [collectors.normalize_title(t) for t in TITLES] == [
        jcollectors.normalize_title(t) for t in TITLES]
    assert vars(collectors.CollectorConfig()) == vars(
        jcollectors.CollectorConfig())
    assert collectors.CollectorStats().as_dict() == \
        jcollectors.CollectorStats().as_dict()
    folder = tmp_path / "col"
    (folder / "artist").mkdir(parents=True)
    (folder / "great_song.mp3").write_bytes(b"x" * 2048)
    (folder / "Other Song (Lyric Video).mp3").write_bytes(b"y" * 4096)
    (folder / "tiny.mp3").write_bytes(b"x")
    (folder / "artist" / "a.mp3").write_bytes(b"z" * 10)
    port = collectors.BatchCollector(collectors.CollectorConfig(
        output_dir=str(tmp_path / "p")))
    jax = jcollectors.BatchCollector(jcollectors.CollectorConfig(
        output_dir=str(tmp_path / "j")))
    for t in TITLES:
        assert port._blocked(t) == jax._blocked(t), t
    keys = port._existing_keys(str(folder))
    assert keys == jax._existing_keys(str(folder))
    assert {"great_song", "other_song"} <= keys and "tiny" not in keys
    zips = [m.package_zip(str(folder), str(tmp_path / f"{k}.zip"))
            for k, m in (("p", collectors), ("j", jcollectors))]
    contents = [{i.filename: zipfile.ZipFile(z).read(i) for i in
                 zipfile.ZipFile(z).infolist()} for z in zips]
    assert contents[0] == contents[1] and len(contents[0]) == 4
    assert collectors.have_ytdlp() == jcollectors.have_ytdlp()
    if not collectors.have_ytdlp():   # no network is used
        assert port.search("guitar") == [] and port.download("x") is None
        assert port.collect(["a", "b"]).as_dict() == jax.collect(
            ["a", "b"]).as_dict()


def test_collectors_cli_matches_the_original(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    outs = []
    for mod in (collectors, jcollectors):
        monkeypatch.setattr(sys, "argv", ["collectors", "some query",
                                          "An Artist"])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("manifest", ["", "upload/analyze/refilter/roll/"
                                          "tabs/studio"])
def test_minify_html_copy_equals_its_original(manifest):
    """The port's SPA and a snippet with comments and URLs minify to the
    same bytes as with the original, the manifest header included."""
    snippet = ("<!-- c --><html><style>/* x */ a { b: c; }</style><script>"
               "// js\nconst u = 'http://x/y'; /* z */ let a = `//`;"
               "</script>\n<body>  <p>hi</p>  </body></html>")
    spa = (REPO / "aegis_tpu_torch" / "serve" / "static"
           / "index.html").read_text()
    for src in (snippet, spa):
        got = minify_html.minify_html(src, manifest=manifest)
        assert got == jminify.minify_html(src, manifest=manifest)
        assert got.startswith(f"<!-- aegis_tpu SPA | {manifest} -->"
                              if manifest else "<")


def test_make_golden_clips_and_gate(monkeypatch, capsys):
    """The same clips from the port's signal_gen, the same fixture folder,
    and without librosa ``main()`` exits 2 as the original does."""
    got, ref = make_golden.clips(), jmake_golden.clips()
    assert [(n, sr) for n, sr, _ in got] == [(n, sr) for n, sr, _ in ref]
    for (_, _, a), (_, _, b) in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert make_golden.GOLDEN_DIR == jmake_golden.GOLDEN_DIR == str(
        REPO / "tests" / "golden")
    monkeypatch.setitem(sys.modules, "librosa", None)
    for mod in (make_golden, jmake_golden):
        with pytest.raises(SystemExit) as err:
            mod.main()
        assert err.value.code == 2
    assert "librosa is not installed" in capsys.readouterr().err


def _artifact(path: Path, device, value: float, **extra) -> None:
    path.write_text(json.dumps({"metric": "realtime_factor", "value": value,
                                "unit": "x_realtime", "device": device,
                                **extra}))


GPU = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
       "power_limit": "700.00 W", "count": 1}


def test_bench_table_skips_tpu_and_cpu_artifacts(tmp_path):
    """Only an artifact with an NVIDIA card, its name and its power limit is
    citable: newer TPU, CPU and nameless GPU records are skipped, and the
    skip is declared in the caption beside the card's name and limit."""
    _artifact(tmp_path / "BENCH_r01.json", GPU, 321.5, v1_rtf=600.25)
    _artifact(tmp_path / "BENCH_r02.json", "tpu", 555.0)
    _artifact(tmp_path / "BENCH_r03.json", "cpu_fallback", 8.7)
    _artifact(tmp_path / "BENCH_r04.json", {"platform": "gpu", "kind":
                                            "NVIDIA H100 80GB HBM3"}, 77.0)
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(
        {"n": 5, "parsed": {"value": 66.0, "device": {"platform": "tpu"}}}))
    path, skipped = bench_table.latest_artifact(str(tmp_path))
    assert path.endswith("BENCH_r01.json")
    assert skipped == ["BENCH_r02.json", "BENCH_r03.json", "BENCH_r04.json",
                       "BENCH_r05.json"]
    table = bench_table.render_table(path, skipped)
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in table.splitlines()[1]
    assert "321.5" in table and "600.25" in table
    for other in ("555", "8.7", "77.0", "66.0"):
        assert other not in table
    assert "BENCH_r02.json" in table
    # the JAX tool, on the same folder, cites only the TPU record
    assert jbench_table.latest_artifact(str(tmp_path))[0].endswith(
        "BENCH_r02.json")


def test_bench_table_refuses_without_a_gpu_artifact(tmp_path):
    with pytest.raises(SystemExit, match="no on-card"):
        bench_table.latest_artifact(str(tmp_path))
    _artifact(tmp_path / "BENCH_r01.json", "tpu", 500.0)
    _artifact(tmp_path / "BENCH_r02.json", "cpu_fallback", 8.7)
    with pytest.raises(SystemExit, match="no on-card.*BENCH_r01.json"):
        bench_table.latest_artifact(str(tmp_path))
    with pytest.raises(SystemExit, match="records no NVIDIA card"):
        bench_table.render_table(str(tmp_path / "BENCH_r01.json"))
    # the repo itself holds TPU artifacts only, so far
    with pytest.raises(SystemExit, match="no on-card"):
        bench_table.latest_artifact(str(REPO))


def test_bench_table_write_owns_only_its_markers(tmp_path, monkeypatch):
    """``--write`` on a README with only the JAX markers raises and leaves
    the file byte-equal; with the port's markers it rewrites its own block
    and leaves the JAX block byte-equal."""
    monkeypatch.setattr(bench_table, "REPO", str(tmp_path))
    jax_block = JAX_BLOCK.search((REPO / "README.md").read_text()).group(0)
    readme = tmp_path / "README.md"
    only_jax = f"# t\n\n{jax_block}\n\ntext\n"
    readme.write_text(only_jax)
    _artifact(tmp_path / "BENCH_r01.json", GPU, 321.5)
    with pytest.raises(SystemExit, match="no TORCH_BENCH_TABLE markers"):
        bench_table.main(["--write"])
    assert readme.read_bytes() == only_jax.encode()

    both = (only_jax + f"\n{bench_table.START} (none yet) -->\nSTALE ROW\n"
            f"{bench_table.END}\n")
    readme.write_text(both)
    assert bench_table.main(["--write"]) == 0
    out = readme.read_text()
    assert JAX_BLOCK.search(out).group(0) == jax_block
    assert out.startswith(only_jax) and "STALE ROW" not in out
    assert "BENCH_r01.json" in out and "700.00 W" in out
    assert len(JAX_BLOCK.findall(out)) == 1


def test_bench_table_leaves_the_real_readme_alone():
    """On the repo's README: the JAX regex still matches the JAX block only,
    the port's markers stand outside it, and the port's tool refuses to
    write (no on-card artifact yet), leaving the file byte-equal."""
    before = (REPO / "README.md").read_bytes()
    text = before.decode()
    blocks = JAX_BLOCK.findall(text)
    assert len(blocks) == 1 and "TORCH" not in blocks[0]
    assert blocks[0] == jbench_table.render_table(
        *jbench_table.latest_artifact(str(REPO)))
    port = re.findall(re.escape(bench_table.START) + r".*?"
                      + re.escape(bench_table.END), text, re.S)
    assert len(port) == 1 and port[0] not in blocks[0]
    with pytest.raises(SystemExit, match="no on-card"):
        bench_table.main(["--write"])
    assert (REPO / "README.md").read_bytes() == before
