"""How ``pytest tests/`` runs: which tests are ``slow``, their order, and
a time limit for each test. It acts on the tests under ``tests/`` only.

- ``SLOW``: tests of the JAX package whose call took 60 s or more on the
  CPU under ``-n 6`` (each compiles interpret-mode Pallas kernels or an
  8-device shard_map program; they hold the JAX package against itself).
  They get the ``slow`` marker, so ``-m 'not slow'`` leaves them out and
  ``-m slow`` runs them on purpose.
- Order: the port's files (``test_torch_*``) first, then the rest in the
  order ``tests/conftest.py`` gives them, so a run cut by its clock ends
  in the JAX package's tests, never in the port's.
- ``TEST_LIMIT_S``: a test without the ``slow`` marker that outlives it
  ends its own process with every thread's stack on stderr, also inside
  a C call (a jaxlib compile, a gloo wait); xdist names the test failed
  and starts a new worker, so a hang costs one test, not the rest of the
  run. It is three times the slowest test outside the marker.
"""

import faulthandler
import os
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"
TEST_LIMIT_S = 180.0

# "file::test[case]" -> the call's seconds on the CPU under -n 6, and why.
SLOW = {
    # test_early_term.py: interpret-mode Pallas compiles
    "test_early_term.py::test_eps0_matches_one_shot": "733 s",
    # fails on every tree: its scene is not opaque, so no ray terminates
    # (ROADMAP queue C, settled); the behaviour is held by
    # test_torch_serve.py::test_early_term_matches_jax_and_sheds_rows
    "test_early_term.py::test_opaque_terminates_and_matches": "643 s",
    "test_early_term.py::test_invalid_rays_skip_fg_get_bg": "482 s alone under -n 2",
    "test_early_term.py::test_render_image_early_term_matches": "509 s",
    # test_fused_train.py: interpret-mode Pallas compiles
    "test_fused_train.py::test_forward_parity": "218 s",
    "test_fused_train.py::test_gradient_parity": "308 s",
    "test_fused_train.py::test_render_rays_fused_matches_unfused": "508 s",
    "test_fused_train.py::test_fused_gradients_bitwise_under_gather_mode[gather]": "348 s",
    "test_fused_train.py::test_fused_gradients_bitwise_under_gather_mode[runs]": "323 s",
    # test_renderer_windowed.py: interpret-mode Pallas compiles, and one
    # shard_map render over 8 CPU devices
    "test_renderer_windowed.py::test_windowed_matches_staged": "236 s",
    "test_renderer_windowed.py::test_bg_seam_continuity": "248 s",
    "test_renderer_windowed.py::test_render_sharded_matches_single": "482 s",
    "test_renderer_windowed.py::test_bf16_tables_render_close": "329 s alone under -n 2",
    "test_renderer_windowed.py::test_fused_decoder_matches_unfused": "160 s",
    "test_renderer_windowed.py::test_windowed_lut_render_matches_no_lut": "358 s",
    "test_renderer_windowed.py::test_features_flat_matches_fallback": "180 s",
    "test_renderer_windowed.py::test_render_permute_runs_bitwise": "178 s",
    # test_table_parallel.py: shard_map compiles over 8 CPU devices
    "test_table_parallel.py::test_sharded_grads_match_unsharded": "115 s",
    "test_table_parallel.py::test_sharded_encode_gather_permute_mode[gather]": "166 s",
    "test_table_parallel.py::test_sharded_encode_gather_permute_mode[runs]": "200 s",
    "test_table_parallel.py::test_table_parallel_train_step_matches_unsharded": "385 s",
    # test_pallas_hash.py: interpret-mode Pallas compiles
    "test_pallas_hash.py::test_backward_bf16_onehot_bounded_error": "92 s",
    "test_pallas_hash.py::test_permute_gather_mode_bitwise_parity[gather]": "154 s",
    "test_pallas_hash.py::test_permute_gather_mode_bitwise_parity[gather_narrow]": "127 s",
    "test_pallas_hash.py::test_permute_gather_mode_bitwise_parity[runs]": "146 s",
    # interpret-mode Pallas compiles
    "test_field_windowed.py::test_windowed_render_grads_match_oracle": "111 s",
    "test_dead_compaction.py::test_grads_with_dead_routing": "91 s",
    # 60 jitted train steps
    "test_train_step.py::test_train_step_runs_and_decreases_loss": "88 s",
}

_STDERR_FD = pytest.StashKey[int]()


def _in_tests(item) -> bool:
    return item.path.resolve().parent == TESTS


def _key(item) -> str:
    return f"{item.path.name}::{item.name}"


def pytest_configure(config):
    # A test's own stderr is captured, and what it holds is lost when its
    # process ends: the stacks go to a copy of the real one.
    config.stash[_STDERR_FD] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


def pytest_itemcollected(item):
    # as each test is collected, so before -m selects
    if _in_tests(item) and _key(item) in SLOW:
        item.add_marker(pytest.mark.slow)


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    # after tests/conftest.py's own order, which the sort keeps within each group
    items.sort(key=lambda item: not (_in_tests(item) and item.path.name.startswith("test_torch_")))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    limited = _in_tests(item) and item.get_closest_marker("slow") is None
    if limited:
        faulthandler.dump_traceback_later(TEST_LIMIT_S, exit=True,
                                          file=item.config.stash[_STDERR_FD])
    yield
    if limited:
        faulthandler.cancel_dump_traceback_later()
