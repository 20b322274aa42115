"""The phase scripts' cut builds still apply to the kernel sources.

scripts/b1_b4_phases.py, b2_b7_phases.py, b5_phases.py, b6_b9_phases.py,
b10_phases.py and b11_phases.py time the port's kernels in builds with a phase cut out of the source
text (see each script's docstring; scripts/_phases.py applies the cuts). A cut is a text patch that must find
its markers; after an edit of a kernel it may no longer apply, and then
the script fails only on the card. Here every cut build of the current
tree is applied to a copy of tdc_tpu_torch/csrc/ under tmp_path: it must
apply and it must change the text. No nvcc, nothing is built. The
parent builds' cuts match an earlier commit's sources and are not
checked here.
"""

from __future__ import annotations

import importlib.util
import shutil
import sys
from pathlib import Path

import pytest

import tdc_tpu_torch

REPO = Path(__file__).resolve().parent.parent
PKG = Path(tdc_tpu_torch.__file__).resolve().parent  # the scripts' copy root
SCRIPTS = ("b1_b4_phases", "b2_b7_phases", "b5_phases", "b6_b9_phases",
           "b10_phases", "b11_phases")
if str(REPO / "scripts") not in sys.path:  # where the scripts find _phases
    sys.path.append(str(REPO / "scripts"))
import _phases  # noqa: E402


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"phases_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cut_builds():
    # BUILDS: name -> (root, cut, runs)
    return [(script, name) for script in SCRIPTS
            for name, (root, edits, _) in _script(script).BUILDS.items()
            if root == "repo" and edits]


def _sources(tree: Path) -> dict:
    return {p.name: p.read_text()
            for p in sorted((tree / PKG.name / "csrc").iterdir())}


def test_every_script_has_cut_builds():
    scripts = {s for s, _ in _cut_builds()}
    assert scripts == set(SCRIPTS)


@pytest.mark.parametrize("script,build", _cut_builds())
def test_cut_build_applies_and_changes_the_source(tmp_path, script, build):
    shutil.copytree(PKG / "csrc", tmp_path / PKG.name / "csrc")
    before = _sources(tmp_path)
    _phases.cut(tmp_path, _script(script).BUILDS[build][1])
    after = _sources(tmp_path)
    assert after != before, f"{script} {build} left the sources as they were"
    assert after.keys() == before.keys()


@pytest.mark.parametrize("script", SCRIPTS)
def test_a_cut_that_misses_raises(tmp_path, script):
    # A marker that is not in the source, or is in it more than once, must
    # fail loudly, not time a build that cut nothing or too much.
    shutil.copytree(PKG / "csrc", tmp_path / PKG.name / "csrc")
    source = next(edits[0][0] for root, edits, _ in
                  _script(script).BUILDS.values() if root == "repo" and edits)
    for marker in ("no such source text", "\n"):
        with pytest.raises(ValueError):
            _phases.cut(tmp_path, _phases.edit(source,
                                               swaps=((marker, ""),)))
