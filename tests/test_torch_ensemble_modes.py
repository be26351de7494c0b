"""percnn_tpu_torch.experiments.ensemble on the CPU: ``run_ensemble`` against
percnn_tpu's in the per-member modes ('fused', 'fused_pg': a loop of the
single model's fused rollouts; 'two_phase'), with the set-up and bar of
tests/test_torch_ensemble.py (the batched modes are there).
"""

import pytest

from test_torch_ensemble import check_matches_jax, members  # noqa: F401  (a fixture)


@pytest.mark.parametrize("bptt", ["fused", "fused_pg", "two_phase"])
def test_run_ensemble_matches_jax(monkeypatch, members, tmp_path, bptt):  # noqa: F811
    check_matches_jax(monkeypatch, members, tmp_path, bptt)
