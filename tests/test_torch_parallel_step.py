"""The data-parallel train step, a port of ``tests/test_multiprocess_dp.py``:
2 ranks x 4 images against 1 process x 8 through the port's loader and
``Trainer`` (``tests/_torch_dp.py``, gloo on the CPU), the first step
against the reference's on the same global batch and weights, and the
factory names with parameters no loss term reaches."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import release_compiled, release_resources  # noqa: F401
from _torch_dp import start_ranks, wait_ranks
from _torch_port import port_state_dict
from _torch_train_step import _reference_step, check_step, step_case


def _assert_ranks_identical(ranks) -> None:
    a, b = ranks[0]["model"], ranks[1]["model"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), f"ranks diverge at {k}"


@pytest.mark.parametrize("name", ["res_18", "dla_34"])
def test_two_ranks_match_one_process(name, tmp_path):
    """2 SGD steps (lr 0.01, seed 7, 64x64; dla_34 under ``xla``, its DCN
    sites on K2's plain version) of the seeded synthetic split, global
    batch 8, 2 ranks x 4 against 1 process x 8: the two ranks' parameters
    and BatchNorm buffers are bit-identical, and equal the one-process
    run's at the reference test's tolerances (rtol 2e-3, atol 2e-5; the
    losses rtol 1e-3).  The models compute in float64: in float32 these
    seeded steps are ill-conditioned (BatchNorm on 32 values per channel
    at the stride-32 maps, E[x^2] - E[x]^2): dla_34's float32 gradients
    lie up to 8e-3 from its float64 ones, and one process fed the same 8
    images in another order moves its parameters past those tolerances
    (50 elements for dla_34, 14 for res_18); in float64 a wrong
    normalizer or an unsynchronised BatchNorm still moves them by
    percents.  SGD for the reason ``tests/_mp_worker.py`` gives."""
    runs = [start_ranks("step", w, tmp_path, name=name, dtype="float64")
            for w in (2, 1)]
    two, (one,) = (wait_ranks(h) for h in runs)
    _assert_ranks_identical(two)
    assert len(one["losses"]) == 2
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-3)
    assert two[0]["losses"] == two[1]["losses"]
    for k, want in one["model"].items():
        got = two[0]["model"][k]
        assert got.dtype == want.dtype, k
        if want.is_floating_point():
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                                       atol=2e-5, err_msg=k)
        else:  # num_batches_tracked
            assert torch.equal(got, want), k


def test_grad_accum_two_ranks_match_one_process(tmp_path):
    """``train.grad_accum 2``: the micro-batch before each update runs
    under DDP's ``no_sync`` (each rank keeps its own gradient sum) and the
    update's all-reduce averages the sums.  res_18, 4 micro-batches of 8
    (2 updates), float64 as above: the ranks bit-identical and equal to
    one process with the same accumulation at the same tolerances."""
    runs = [start_ranks("step", w, tmp_path, name="res_18", dtype="float64",
                        accum=2, steps=4, images=32) for w in (2, 1)]
    two, (one,) = (wait_ranks(h) for h in runs)
    _assert_ranks_identical(two)
    assert two[0]["updates"] == one["updates"] == 2
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-3)
    for k, want in one["model"].items():
        if want.is_floating_point():
            np.testing.assert_allclose(two[0]["model"][k].numpy(),
                                       want.numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=k)


@pytest.mark.parametrize("name", [
    "res_18", pytest.param("dla_34", marks=pytest.mark.slow)])
def test_first_step_matches_reference(name, tmp_path):
    """The first step on 2 ranks, one image each, of
    ``tests/_torch_train_step.py``'s case (seeded weights in the
    reference's variable tree, a compact-wire batch of 2 that both
    encoders make bit-equal, Adam): the ranks' states bit-identical, and
    the global loss, the all-reduced gradients, the BatchNorm statistics
    after the step and Adam's update held to the reference's float64 step
    exactly as ``check_train_step`` holds one process (``TOL``, or the
    reference's own float32 distance where the step is ill-conditioned)."""
    jcfg, tcfg, variables, batch = step_case(name)
    case = tmp_path / "case.pt"
    torch.save({"cfg": tcfg, "batch": batch,
                "state_dict": port_state_dict(variables)}, case)
    handle = start_ranks("ref_step", 2, tmp_path, case=case)
    ref64 = _reference_step(jcfg, variables, batch, jnp.float64)
    ranks = wait_ranks(handle)
    _assert_ranks_identical(ranks)
    r = ranks[0]
    assert r["stats"] == ranks[1]["stats"]
    for k, g in r["grads"].items():
        assert (g is None) == (ranks[1]["grads"][k] is None), k
        assert g is None or torch.equal(g, ranks[1]["grads"][k]), k
    check_step(jcfg, tcfg, variables, batch, ref64, r["stats"], r["grads"],
               r["model"])


def test_unused_parameters_two_ranks(tmp_path):
    """efficientnet, whose last bottom-up path feeds no loss term: 2 Adam
    steps (global batch 4) on 2 ranks run (DDP finds the unused
    parameters at each forward), the ranks stay bit-identical, and the
    optimizer keeps state for exactly the parameters the one-process
    Trainer keeps it for, of the same shapes (none for the unused ones),
    so either loads the other's checkpoints."""
    runs = [start_ranks("step", w, tmp_path, name="efficientnet", images=8,
                        batch=4, optimizer="adam")
            for w in (2, 1)]
    two, (one,) = (wait_ranks(h) for h in runs)
    _assert_ranks_identical(two)
    assert two[0]["opt_layout"] == two[1]["opt_layout"] == one["opt_layout"]
    assert 0 < len(one["opt_layout"]) < one["n_params"]
