"""Every file a CUDA source of finch_tpu_torch includes with quotes ships
with the package: it exists in csrc/ and matches a glob of the package's
package-data entry in pyproject.toml, so that a non-editable install can
build the kernels."""

import fnmatch
import os
import re
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "finch_tpu_torch", "csrc")
SOURCES = sorted(f for f in os.listdir(CSRC)
                 if f.endswith((".cu", ".cuh")))
INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _package_globs():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        doc = tomllib.load(f)
    return doc["tool"]["setuptools"]["package-data"]["finch_tpu_torch"]


def _shipped(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in _package_globs())


def test_sources_found():
    assert {"extract.cu", "dedup.cu", "warp.cuh"} <= set(SOURCES)


@pytest.mark.parametrize("source", SOURCES)
def test_quoted_includes_are_package_data(source):
    text = open(os.path.join(CSRC, source)).read()
    assert _shipped(f"csrc/{source}"), source
    for name in INCLUDE.findall(text):
        assert os.path.isfile(os.path.join(CSRC, name)), (source, name)
        assert _shipped(f"csrc/{name}"), (source, name)
