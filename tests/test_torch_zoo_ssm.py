"""The tests of ``tests/test_torch_zoo.py`` on the SSM and hybrid
architectures' smoke configs: xLSTM-350M (mLSTM and sLSTM layers) and
Zamba2-1.2B (Mamba2 layers and the shared attention block).

Each test here runs the zoo test of the same name on one of these two
architectures, with the same bars (configs field by field, scan groups,
parameter and cache trees, caches' initial values, ``forward`` and
``decode_step`` 1e-4 in float32 and 3e-2 in bfloat16, ``forward`` vs
decode, the prefill step, ``serve_batch`` tokens, the CLI). They live in
a file of their own so that the suite's parallel workers, which take a
file each, share the zoo's CPU time.
"""

import pytest
import torch

import test_torch_zoo as zoo

ARCHES = ("xlstm-350m", "zamba2-1.2b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke models are tiny, and under the
    suite's parallel workers torch's default of a thread per core in every
    worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHES)
def test_get_config_equals_the_reference_field_by_field(arch):
    zoo.test_get_config_equals_the_reference_field_by_field(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_scan_groups_match_the_reference(arch):
    zoo.test_scan_groups_match_the_reference(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_jax_carries_every_leaf(arch):
    zoo.test_params_from_jax_carries_every_leaf(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_init_params_tree_matches_the_reference(arch):
    zoo.test_init_params_tree_matches_the_reference(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_full_width_trees_match_the_reference_by_shape(arch):
    zoo.test_full_width_trees_match_the_reference_by_shape(arch)


@pytest.mark.parametrize("long_mode", [False, True], ids=["full", "long"])
@pytest.mark.parametrize("arch", ARCHES)
def test_init_cache_matches_the_reference(arch, long_mode):
    zoo.test_init_cache_matches_the_reference(arch, long_mode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_the_reference(arch, dtype):
    zoo.test_forward_matches_the_reference(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_decode_step_matches_the_reference(arch, dtype):
    zoo.test_decode_step_matches_the_reference(arch, dtype)


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_forward(arch):
    zoo.test_decode_matches_forward(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_step_matches_the_reference(arch):
    zoo.test_prefill_step_matches_the_reference(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_serve_batch_tokens_equal_the_reference(arch):
    zoo.test_serve_batch_tokens_equal_the_reference(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_cli_serves_the_smoke_config(arch, capsys):
    zoo.test_cli_serves_the_smoke_config(arch, capsys)
