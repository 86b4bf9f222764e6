"""The stdlib half of ``torcheval_tpu_torch.analysis`` against the JAX
package's: the lint, the lock-discipline pass and the concurrency
verifier run over the JAX tree in both packages and agree finding for
finding (the named lint differences aside); the rule catalogue matches;
each torch rule form fires on a seeded fixture and passes its clean twin;
module names are rooted at the package swept (the cross-module cycle the
JAX naming misses); the stdlib layers stay torch-free; and the CLI's
exit codes, ``--list-rules`` and its refusal to check nothing."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import torcheval_tpu
import torcheval_tpu_torch
from torcheval_tpu.analysis import check_concurrency as jax_check_concurrency
from torcheval_tpu.analysis import check_locks as jax_check_locks
from torcheval_tpu.analysis import RULES as JAX_RULES
from torcheval_tpu.analysis import lint_paths as jax_lint_paths
from torcheval_tpu_torch.analysis import (
    RULES,
    check_concurrency,
    check_locks,
    lint_file,
    lint_paths,
)
from torcheval_tpu_torch.analysis.__main__ import main as cli_main
from torcheval_tpu_torch.analysis.annotations import CONCURRENCY_RULE_IDS
from torcheval_tpu_torch.analysis.concurrency import DEFAULT_TARGETS
from torcheval_tpu_torch.analysis.locks import build_universe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.dirname(os.path.abspath(torcheval_tpu.__file__))
PORT_DIR = os.path.dirname(os.path.abspath(torcheval_tpu_torch.__file__))


def _keys(report):
    return {
        (f.rule, os.path.relpath(f.path, REPO), f.line, f.suppressed)
        for f in report.findings
    }


# -------------------------------------------- the two packages, one tree


def test_concurrency_verifiers_agree_over_the_jax_tree():
    # the torch.distributed and parallel/ collective names the port adds
    # to the hazard model name no call in the JAX tree: no difference
    port = check_concurrency([JAX_DIR], record=False)
    ref = jax_check_concurrency([JAX_DIR], record=False)
    assert port.checked == ref.checked > 0
    assert _keys(port) == _keys(ref)


def test_lock_passes_agree_over_the_jax_tree():
    port = check_locks([JAX_DIR])
    ref = jax_check_locks([JAX_DIR])
    assert port.checked == ref.checked > 0
    assert _keys(port) == _keys(ref)


# The lint differs only where a rule takes its torch form. Port-only:
# ``ffi-import`` flags the ctypes loader of the JAX package's native CPU
# kernels (the torch form: no ``ctypes`` load outside ``ops/_kernels.py``),
# and ``host-sync`` covers ``metrics/_bucket.py`` (on the port's update
# path, the padding runs on every bucketed update). JAX-only: three
# suppressed ``jax.device_get`` reads, a spelling the torch form does not
# know.
_LINT_PORT_ONLY = {
    ("ffi-import", "torcheval_tpu/ops/native/__init__.py", False),
    ("host-sync", "torcheval_tpu/metrics/_bucket.py", False),
}
_LINT_JAX_ONLY = {
    ("host-sync", "torcheval_tpu/metrics/functional/classification/precision_recall_curve.py", True),
}


def test_lints_agree_over_the_jax_tree_but_for_the_torch_forms():
    port = lint_paths([JAX_DIR])
    ref = jax_lint_paths([JAX_DIR])
    assert port.checked == ref.checked > 0
    mine, theirs = _keys(port), _keys(ref)
    assert {(r, p, s) for r, p, _, s in mine - theirs} == _LINT_PORT_ONLY
    assert {(r, p, s) for r, p, _, s in theirs - mine} == _LINT_JAX_ONLY
    assert len(mine - theirs) == 3 and len(theirs - mine) == 3


def test_rule_catalogue_matches_the_jax_package():
    assert sorted(RULES) == sorted(JAX_RULES)


def test_default_targets_exist_in_the_port():
    for target in DEFAULT_TARGETS:
        assert os.path.exists(os.path.join(PORT_DIR, target)), target


# -------------------------------------------------- the port over itself


def test_port_is_clean_under_its_own_lint_and_verifier():
    lint = lint_paths([PORT_DIR])
    conc = check_concurrency([PORT_DIR], record=False)
    assert lint.active == [], [f.format() for f in lint.active]
    assert conc.active == [], [f.format() for f in conc.active]
    assert all(f.suppress_reason for f in lint.findings + conc.findings)


# --------------------------------------------- torch rule forms, seeded

SEEDED = {
    "ffi-import": ("import ctypes\nlib = ctypes.CDLL('x.so')\n", "import ctypes\nlib = None\n"),
    "ffi-import:load_library": (
        "import torch\ntorch.ops.load_library('x.so')\n",
        "import torch\nx = torch.ops.aten\n",
    ),
    "ffi-import:cpp_extension": (
        "from torch.utils.cpp_extension import load\nm = load('x', ['x.cu'])\n",
        "from torch.utils import data\n",
    ),
    "env-truthy": (
        "import os\nflag = os.environ.get('X', '').lower() in ('1', 'true', 'yes')\n",
        "from torcheval_tpu_torch.config import env_truthy\nflag = env_truthy('X')\n",
    ),
    "host-sync": ("def f(x):\n    return x.sum().item()\n", "def f(x):\n    return x.sum()\n"),
    "host-sync:cpu": ("def f(x):\n    return x.cpu()\n", "def f(x):\n    return x.cuda()\n"),
    "host-sync:synchronize": (
        "import torch\ndef f(x):\n    torch.cuda.synchronize()\n    return x\n",
        "import torch\ndef f(x):\n    torch.cuda.current_stream()\n    return x\n",
    ),
    "host-sync:numpy": (
        "import numpy as np\ndef f(x):\n    return np.asarray(x)\n",
        "import numpy as np\ndef f(x):\n    return np.float32(1.0)\n",
    ),
    "time-in-jit": (
        "import time, torch\ndef f(g):\n    with torch.cuda.graph(g):\n        t = time.monotonic()\n",
        "import time, torch\ndef f(g):\n    t = time.monotonic()\n    with torch.cuda.graph(g):\n        pass\n",
    ),
    "time-in-jit:capture_begin": (
        "import time\ndef f(g):\n    g.capture_begin()\n    t = time.perf_counter()\n    g.capture_end()\n",
        "import time\ndef f(g):\n    g.capture_begin()\n    g.capture_end()\n    t = time.perf_counter()\n",
    ),
    "time-in-jit:plan_kernel": (
        "import time\nfrom m import UpdatePlan\n"
        "def _kernel(x):\n    return x * time.time()\n"
        "def plan(x):\n    return UpdatePlan(_kernel, ('s',), (x,))\n",
        "import time\nfrom m import UpdatePlan\n"
        "def _kernel(x):\n    return x\n"
        "def plan(x):\n    t = time.time()\n    return UpdatePlan(_kernel, ('s',), (x,))\n",
    ),
    "time-in-jit:update_plan_tuple": (
        "import time\nclass M:\n"
        "    def _update_plan(self, x):\n        return (self._k, ('s',), (x,))\n"
        "    def _k(self, x):\n        return x + time.monotonic()\n",
        "import time\nclass M:\n"
        "    def _update_plan(self, x):\n        return (self._k, ('s',), (x,))\n"
        "    def _k(self, x):\n        return x\n",
    ),
    "shard-map-import": (
        "from torch.distributed._tensor import DTensor\n",
        "from torch.distributed.tensor import DTensor\n",
    ),
    "bare-lock": (
        "import threading\nLOCK = threading.Lock()\n",
        "import threading\nLOCK = threading.Lock()\nSTATE = {}  # tev: guarded-by=LOCK\n",
    ),
}
# host-sync applies to update-reachable modules only
_SCOPED = {"host-sync"}


def _lint_source(tmp_path, source, rule):
    base = rule.split(":")[0]
    directory = tmp_path / "torcheval_tpu_torch" / ("ops" if base in _SCOPED else "x")
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "fixture.py"
    path.write_text(source)
    return lint_file(str(path), rules=[base])


@pytest.mark.parametrize("rule", sorted(SEEDED))
def test_torch_rule_form_fires_on_a_seeded_fixture_and_passes_its_twin(rule, tmp_path):
    seeded, clean = SEEDED[rule]
    base = rule.split(":")[0]
    assert base in {f.rule for f in _lint_source(tmp_path / "s", seeded, rule).active}
    assert _lint_source(tmp_path / "c", clean, rule).active == []


def test_every_rule_has_a_seeded_fixture():
    assert {r.split(":")[0] for r in SEEDED} == set(RULES)


def test_host_sync_is_scoped_to_update_reachable_modules(tmp_path):
    source = "def f(x):\n    return x.item()\n"
    for rel, fires in (
        ("ops/a.py", True),
        ("metrics/functional/b.py", True),
        ("metrics/_fuse.py", True),
        ("metrics/_bucket.py", True),
        ("metrics/sharded.py", True),
        ("ops/_kernels.py", False),
        ("metrics/functional/text/c.py", False),
        ("metrics/synclib.py", False),
        ("distributed.py", False),
    ):
        path = tmp_path / "torcheval_tpu_torch" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source)
        got = {f.rule for f in lint_file(str(path)).active}
        assert ("host-sync" in got) is fires, rel


def test_ffi_import_exempts_the_kernel_loader(tmp_path):
    path = tmp_path / "torcheval_tpu_torch" / "ops" / "_kernels.py"
    path.parent.mkdir(parents=True)
    path.write_text("import ctypes\nlib = ctypes.CDLL('x.so')\n")
    assert lint_file(str(path)).active == []


def test_reasonless_suppression_is_a_bad_suppression(tmp_path):
    path = tmp_path / "torcheval_tpu_torch" / "ops" / "a.py"
    path.parent.mkdir(parents=True)
    path.write_text("def f(x):\n    return x.item()  # tev: disable=host-sync\n")
    rules = {f.rule for f in lint_file(str(path)).active}
    assert rules == {"bad-suppression", "host-sync"}


# --------------------------------------- module naming, the C10 fixture

_CYCLE = {
    "__init__.py": "",
    "sub/__init__.py": "",
    "sub/fence.py": (
        "import threading\n\n"
        "from torcheval_tpu_torch.sub.group import Group\n\n"
        "FENCE = threading.Lock()\n\n\n"
        "def wait_fence():\n    with FENCE:\n        pass\n\n\n"
        "def fence_all(group: Group):\n    with FENCE:\n        group.note()\n"
    ),
    "sub/group.py": (
        "import threading\n\n"
        "from torcheval_tpu_torch.sub import fence\n\n\n"
        "class Group:\n"
        "    def __init__(self):\n        self._lock = threading.Lock()\n\n"
        "    def sync(self):\n        with self._lock:\n            fence.wait_fence()\n\n"
        "    def note(self):\n        with self._lock:\n            pass\n"
    ),
}


def write_cycle_fixture(root):
    """The lock-order cycle of a fence lock and a group lock acquired in
    opposite orders through calls, split across two modules of a
    ``torcheval_tpu_torch/sub/`` package; returns the package root."""
    pkg = root / "torcheval_tpu_torch"
    for rel, source in _CYCLE.items():
        path = pkg / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source)
    return pkg


def test_cross_module_cycle_is_caught_by_the_port_and_missed_by_jax(tmp_path):
    pkg = write_cycle_fixture(tmp_path)
    port = check_concurrency([str(pkg)], record=False)
    ref = jax_check_concurrency([str(pkg)], record=False)
    assert port.checked == 4
    assert "lock-order-cycle" in {f.rule for f in port.active}
    # the JAX naming keys on "torcheval_tpu/": both __init__ files read
    # as "__init__", and "torcheval_tpu_torch.sub.group" resolves nowhere
    assert ref.checked == 3
    assert ref.active == []


def test_module_names_are_rooted_at_the_package_swept():
    universe = build_universe([PORT_DIR, JAX_DIR])
    names = list(universe.modules)
    assert len(names) == len(set(names))
    assert "torcheval_tpu_torch.metrics.metric" in names
    assert "torcheval_tpu.metrics.metric" in names
    py_files = sum(
        1
        for top in (PORT_DIR, JAX_DIR)
        for root, _, files in os.walk(top)
        if "__pycache__" not in root
        for f in files
        if f.endswith(".py")
    )
    assert len(names) == py_files


def test_concurrency_rule_ids_match_the_jax_package():
    from torcheval_tpu.analysis.annotations import CONCURRENCY_RULE_IDS as JAX_IDS

    assert CONCURRENCY_RULE_IDS == JAX_IDS


# ------------------------------------------------------ import discipline


def test_lint_and_concurrency_leave_torch_and_jax_unimported():
    code = (
        "import sys\n"
        "import torcheval_tpu_torch.analysis as A\n"
        f"r = A.lint_paths([{PORT_DIR!r}])\n"
        f"c = A.check_concurrency([{PORT_DIR!r}], record=False)\n"
        "assert r.checked > 0 and c.checked > 0\n"
        "print(sorted(m for m in ('torch', 'jax', 'numpy') if m in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_program_symbols_load_lazily():
    import torcheval_tpu_torch.analysis as A

    assert "verify_metric_update" in A.__all__
    assert callable(A.verify_metric_update)
    from torcheval_tpu.analysis import __all__ as jax_all

    assert sorted(A.__all__) == sorted(jax_all)


# --------------------------------------------------------------- the CLI


def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert cli_main([str(clean)]) == 0
    bad = tmp_path / "torcheval_tpu_torch" / "ops" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x):\n    return x.item()\n")
    out = tmp_path / "report.json"
    assert cli_main([str(bad), "--report", "json", "--output", str(out)]) == 1
    report = json.loads(out.read_text())
    assert report["schema_version"] == 1 and report["ok"] is False
    assert report["counts"]["errors"] == 1
    capsys.readouterr()


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    listed = [line.split(":")[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(RULES)


def test_cli_refuses_to_check_nothing(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--no-lint"])
    assert exc.value.code == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as exc:
        cli_main([str(empty)])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        cli_main(["--rules", "no-such-rule", str(empty)])
    assert exc.value.code == 2
    capsys.readouterr()


def test_cli_concurrency_arm_over_the_port(capsys):
    assert cli_main(["--concurrency", "--report", "json", PORT_DIR]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["counts"]["active"] == 0
    assert report["counts"]["suppressed"] >= 27
