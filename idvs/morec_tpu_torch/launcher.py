"""Grid launcher (JAX twin: launcher.py): the reference's train_*.py and
test_*.py scripts (e.g. inbatch_sasrec_e2e_text/train_bert_base.py:30-50)
are nested hyperparameter loops that format a torch.distributed.launch
command line for each point. Here each point runs the port's runner
(``idvs.morec_tpu_torch.run``) in this process, or with
``fresh_process=True`` in a fresh interpreter, with the JAX launcher's
nested-product order, flag names and ``label_screen`` format.

    python -m idvs.morec_tpu_torch.launcher variants/inbatch_sasrec_e2e_vision/train_swin_tiny.py

runs every point of a ``variants/`` file on the card. Those files import
the JAX launcher, so ``read_variant`` reads their ``base``, ``grid`` and
``zipped`` dicts with ``ast`` and never imports them. The data and model
paths are the file's own.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import itertools
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .config import REF_FLAG_ALIASES, Config

LABEL_KEYS = ("item_tower", "batch_size", "embedding_dim", "lr", "drop_rate",
              "l2_weight", "fine_tune_lr")
VARIANT_DICTS = ("base", "grid", "zipped")
# a fresh interpreter's point on a named device (the CLI runs on the card)
_FRESH_ON = ("import sys; from idvs.morec_tpu_torch.run import main; "
             "main(sys.argv[2:], device=sys.argv[1])")


def _known_flags() -> set:
    """Every flag the runner's CLI accepts: the Config fields, the
    reference's own spellings (``REF_FLAG_ALIASES``) and the
    launcher-only keys."""
    names = {f.name for f in dataclasses.fields(Config)}
    names.update(REF_FLAG_ALIASES)
    names.update({"label_screen", "local_rank"})
    return names


def grid_launch(base: Dict[str, object], grid: Dict[str, Sequence],
                label_keys: Sequence[str] = LABEL_KEYS,
                fresh_process: bool = False,
                zipped: Optional[Dict[str, Sequence]] = None,
                device=None) -> List[tuple]:
    """Runs every point of the grid: the product of ``grid``'s axes in
    their order, and within each product point the ``zipped`` axes taken
    together by index (the reference's test_*.py pair
    load_ckpt_name_list[i] with dnn_layers_list[i],
    bce_text/id_plus_mo-2stage/test_bert_add.py:38-41). Each point's flags
    are ``base`` updated by its values, and ``label_screen`` defaults to
    the ``label_keys`` values joined by ``_``. Returns [(flags, result)]:
    ``run``'s result in this process, the exit code in a fresh one.
    ``device`` goes to ``run`` (None: the card).

    A flag the runner cannot express is refused here, naming it, before
    any point runs: a grid axis must not be dropped silently."""
    zipped = zipped or {}
    unknown = (set(base) | set(grid) | set(zipped)) - _known_flags()
    if unknown:
        raise ValueError(
            f"grid_launch: flags {sorted(unknown)} are not expressible — "
            "add them to Config (or REF_FLAG_ALIASES) instead of silently "
            "dropping a reference grid axis")
    if zipped:
        lens = {k: len(v) for k, v in zipped.items()}
        if len(set(lens.values())) > 1:
            raise ValueError(f"grid_launch: zipped axes differ in length: "
                             f"{lens}")
        zip_points = [dict(zip(zipped, vals)) for vals in
                      zip(*zipped.values())]
    else:
        zip_points = [{}]
    results = []
    keys = list(grid)
    for values in itertools.product(*(grid[k] for k in keys)):
        for zp in zip_points:
            flags = dict(base)
            flags.update(zip(keys, values))
            flags.update(zp)
            flags.setdefault("label_screen", "_".join(
                str(flags.get(k, "")) for k in label_keys))
            argv = [a for k, v in flags.items() for a in (f"--{k}", str(v))]
            if fresh_process:
                head = (["-m", "idvs.morec_tpu_torch.run"] if device is None
                        else ["-c", _FRESH_ON, str(device)])
                res = subprocess.run([sys.executable, *head, *argv]
                                     ).returncode
            else:
                from .run import main
                res = main(argv, device=device)
            results.append((flags, res))
    return results


def _dict_call(node: ast.AST, path: str, name: str) -> dict:
    """A ``dict(key=literal, ...)`` call's dict; anything else raises,
    naming the file."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "dict" and not node.args
            and all(kw.arg is not None for kw in node.keywords)):
        raise ValueError(f"{path}: {name} is not a dict(key=value, ...) "
                         f"call")
    out = {}
    for kw in node.keywords:
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except ValueError as e:
            raise ValueError(f"{path}: {name}[{kw.arg!r}] is not a "
                             f"literal") from e
    return out


def _main_guard(node: ast.AST) -> bool:
    """``if __name__ == "__main__":``, whose body runs only as a script."""
    return (isinstance(node, ast.If) and ast.unparse(node.test)
            in ("__name__ == '__main__'", "'__main__' == __name__"))


def read_variant(path: str) -> Tuple[dict, dict, Optional[dict]]:
    """(base, grid, zipped or None) of a ``variants/`` file, parsed with
    ``ast`` and not imported (the files import the JAX launcher). Each is
    assigned once, at the top level, as ``dict(key=literal, ...)``; the
    file may hold besides only its docstring, imports and the ``if
    __name__ == "__main__":`` block. Anything else raises, naming the
    file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found: Dict[str, dict] = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in VARIANT_DICTS
                and node.targets[0].id not in found):
            name = node.targets[0].id
            found[name] = _dict_call(node.value, path, name)
        elif not (isinstance(node, (ast.Import, ast.ImportFrom))
                  or _main_guard(node)
                  or (isinstance(node, ast.Expr)
                      and isinstance(node.value, ast.Constant))):
            raise ValueError(f"{path}:{node.lineno}: a statement the "
                             f"variant reader does not take")
    if "base" not in found or "grid" not in found:
        raise ValueError(f"{path}: no base and grid dicts")
    return found["base"], found["grid"], found.get("zipped")


def main(argv=None) -> List[tuple]:
    parser = argparse.ArgumentParser(
        description="Runs every grid point of a variants/ file through the "
                    "port's runner, on the card.")
    parser.add_argument("variant", help="a variants/**/*.py launcher file")
    args = parser.parse_args(argv)
    base, grid, zipped = read_variant(args.variant)
    return grid_launch(base, grid, zipped=zipped)


if __name__ == "__main__":
    main()
