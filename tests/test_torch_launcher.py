"""The port's grid launcher (``launcher.py``) against the JAX package's on
the CPU:

- ``read_variant`` of each of the 50 ``variants/`` files equals the
  ``base``, ``grid`` and ``zipped`` its import defines, and refuses, naming
  the file, what it cannot read without importing;
- ``grid_launch`` over each file gives the JAX launcher's points in its
  order, the same flags, ``label_screen`` values and command lines, with
  ``run`` stubbed out in both packages;
- unknown flags and zipped axes of unequal length are refused as the JAX
  launcher refuses them; ``fresh_process`` runs the port's CLI;
- the CLI (``python -m idvs.morec_tpu_torch.launcher <file>``) launches the
  file's dicts.
"""

import glob
import importlib.util
import os
import sys

import pytest

from idvs.morec_tpu import launcher as jlauncher
from idvs.morec_tpu import run as jrun
from idvs.morec_tpu_torch import launcher
from idvs.morec_tpu_torch import run as trun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = sorted(glob.glob(os.path.join(REPO, "variants", "**", "*.py"),
                            recursive=True))
IDS = [os.path.relpath(p, os.path.join(REPO, "variants")) for p in VARIANTS]


def _imported(path: str) -> tuple:
    spec = importlib.util.spec_from_file_location("variant_under_test",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.base, module.grid, getattr(module, "zipped", None)


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' run.main replaced by a recorder: [(package, argv,
    device)]."""
    calls = []
    monkeypatch.setattr(jrun, "main", lambda argv=None: calls.append(
        ("jax", argv, None)) or len(calls))
    monkeypatch.setattr(trun, "main", lambda argv=None, device=None:
                        calls.append(("torch", argv, device)) or len(calls))
    return calls


def test_all_variant_files_are_read():
    assert len(VARIANTS) == 50


@pytest.mark.parametrize("path", VARIANTS, ids=IDS)
def test_read_variant_matches_import(path):
    assert launcher.read_variant(path) == _imported(path)


@pytest.mark.parametrize("path", VARIANTS, ids=IDS)
def test_points_match_jax(stubbed, path):
    base, grid, zipped = launcher.read_variant(path)
    want = jlauncher.grid_launch(base, grid, zipped=zipped)
    jax_calls = list(stubbed)
    stubbed.clear()
    got = launcher.grid_launch(base, grid, zipped=zipped, device="cpu")
    assert [flags for flags, _ in got] == [flags for flags, _ in want]
    assert [c[1] for c in stubbed] == [c[1] for c in jax_calls]
    assert all(c[2] == "cpu" for c in stubbed)
    assert [r for _, r in got] == [r for _, r in want]
    assert len(got) >= 1 and all("label_screen" in f for f, _ in got)


def test_labels_and_order(stubbed):
    """The nested product in the grid's key order, the zipped axes inside
    each product point, ``label_screen`` from label_keys unless given."""
    base = dict(item_tower="modal", lr=1e-4)
    grid = dict(batch_size=[8, 16], embedding_dim=[32, 64])
    zipped = dict(dnn_layers=[0, 2], mo_dnn_layers=[4, 8])
    for kw in (dict(zipped=zipped), dict(label_keys=("lr", "dnn_layers",
                                                     "absent"))):
        want = jlauncher.grid_launch(base, grid, **kw)
        got = launcher.grid_launch(base, grid, **kw)
        assert [f for f, _ in got] == [f for f, _ in want]
    assert [f["label_screen"] for f, _ in got] == [
        "0.0001__"] * 4
    got = launcher.grid_launch(dict(base, label_screen="mine"), grid,
                               zipped=zipped)
    assert [(f["batch_size"], f["embedding_dim"], f["dnn_layers"])
            for f, _ in got] == [(b, e, d) for b in (8, 16)
                                 for e in (32, 64) for d in (0, 2)]
    assert {f["label_screen"] for f, _ in got} == {"mine"}


@pytest.mark.parametrize("kw", [
    dict(base=dict(item_tower="id", bogus=1), grid=dict(lr=[1e-4])),
    dict(base=dict(item_tower="id"), grid=dict(mo_dnn_layer=[8])),
    dict(base=dict(item_tower="id"), grid=dict(lr=[1e-4]),
         zipped=dict(dnn_layers=[0, 1], oops=[1, 2])),
    dict(base=dict(item_tower="id"), grid=dict(lr=[1e-4]),
         zipped=dict(dnn_layers=[0, 1], mo_dnn_layers=[1]))],
    ids=["base", "grid", "zipped", "zipped_lengths"])
def test_refusals_match_jax(stubbed, kw):
    """Nothing launches: an unknown flag (a reference axis the runner cannot
    express) and zipped axes of unequal length raise as in JAX."""
    with pytest.raises(ValueError) as want:
        jlauncher.grid_launch(**kw)
    with pytest.raises(ValueError) as got:
        launcher.grid_launch(**kw)
    assert str(got.value) == str(want.value)
    assert not stubbed


def test_reference_flag_spellings_are_known(stubbed):
    """The reference's flag names (config.REF_FLAG_ALIASES) and the
    launcher's own keys pass."""
    base = dict(CV_model_load="swin_tiny", CV_resize=224,
                lmdb_data="x.mkv", local_rank=0, label_screen="a")
    assert len(launcher.grid_launch(base, dict(lr=[1e-4]))) == 1


def test_fresh_process_runs_the_ports_cli(monkeypatch):
    cmds = []

    class Done:
        returncode = 0

    monkeypatch.setattr(launcher.subprocess, "run",
                        lambda cmd: cmds.append(cmd) or Done())
    base, grid = dict(item_tower="id"), dict(lr=[1e-4, 1e-3])
    got = launcher.grid_launch(base, grid, fresh_process=True)
    assert [r for _, r in got] == [0, 0]
    argv = ["--item_tower", "id", "--lr", "0.0001", "--label_screen",
            "id___0.0001___"]
    assert cmds[0] == [sys.executable, "-m", "idvs.morec_tpu_torch.run",
                       *argv]
    launcher.grid_launch(base, grid, fresh_process=True, device="cpu")
    assert cmds[2][:2] == [sys.executable, "-c"]
    assert cmds[2][3:] == ["cpu", *argv]


@pytest.mark.parametrize("source,what", [
    ("base = {'lr': 1}\ngrid = dict(lr=[1])\n", "base is not a dict"),
    ("base = dict(lr=abs(1))\ngrid = dict(lr=[1])\n", "'lr'"),
    ("base = dict(**other)\ngrid = dict(lr=[1])\n", "base is not a dict"),
    ("base = dict(lr=1)\ngrid = dict(lr=[1])\nbase['lr'] = 2\n", ":3:"),
    ("base = dict(lr=1)\ngrid = dict(lr=[1])\nbase = dict(lr=2)\n", ":3:"),
    ("base = dict(lr=1)\nif True:\n    base = dict(lr=2)\n", ":2:"),
    ("base = dict(lr=1)\n", "no base and grid")],
    ids=["literal", "call", "splat", "mutation", "twice", "if", "no_grid"])
def test_read_variant_refuses_what_it_cannot_read(tmp_path, source, what):
    path = tmp_path / "train_x.py"
    path.write_text(source)
    with pytest.raises(ValueError, match="train_x.py") as e:
        launcher.read_variant(str(path))
    assert what in str(e.value)


def test_cli_launches_the_files_dicts(monkeypatch):
    path = os.path.join(REPO, "variants", "bce_text", "id_plus_mo-2stage",
                        "test_bert_add.py")
    seen = []
    monkeypatch.setattr(launcher, "grid_launch",
                        lambda base, grid, zipped=None: seen.append(
                            (base, grid, zipped)) or [])
    launcher.main([path])
    assert seen == [_imported(path)] and seen[0][2] is not None
