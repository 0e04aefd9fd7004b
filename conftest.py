"""Marks seven long items of tests/test_sharded.py `slow`, so that the tier-1
command (`-m 'not slow'`) leaves them out.

They test only the JAX package's sharded render against its single chip, and
each has a mirror in tests/test_torch_parallel.py that tier-1 keeps. The
other nine items of that file stay in tier-1: a sharded render, its
gradients and its telemetry. Times are seconds an item, six items at a time
on an 8-core CPU. Run the seven on their own with

    python -m pytest tests/test_sharded.py -m slow -p xdist -n 6 --dist load -p no:randomly

This file imports nothing but pytest: tests/conftest.py must set XLA_FLAGS
before the first `import jax`.
"""

import pytest

SLOW_NODE_IDS = frozenset({
    # 263.84 s; test_torch_parallel.py::test_sharded_imbalanced_scene_reports_drops
    "tests/test_sharded.py::test_sharded_imbalanced_scene_reports_drops",
    # 189.91 s; test_torch_parallel.py::test_sharded_matches_single_chip[4ranks-a2a_match]
    "tests/test_sharded.py::test_all_to_all_matches_single_chip[8]",
    # 173.38 s; test_torch_parallel.py::test_sharded_matches_single_chip[2ranks-a2a_match]
    "tests/test_sharded.py::test_all_to_all_matches_single_chip[2]",
    # 166.69 s; test_torch_parallel.py::test_all_to_all_send_overflow_reported
    "tests/test_sharded.py::test_all_to_all_send_overflow_reported",
    # 145.31 s; test_torch_parallel.py::test_sharded_matches_single_chip[4ranks-match]
    "tests/test_sharded.py::test_sharded_matches_single_chip[8]",
    # 144.01 s; test_torch_parallel.py::test_sharded_matches_single_chip[2ranks-match]
    "tests/test_sharded.py::test_sharded_matches_single_chip[2]",
    # 126.19 s; test_torch_parallel.py::test_sharded_nondivisible_tile_rows[2ranks], [4ranks]
    "tests/test_sharded.py::test_sharded_nondivisible_tile_rows",
})


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long; the tier-1 command leaves it out")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW_NODE_IDS:
            item.add_marker(pytest.mark.slow)
