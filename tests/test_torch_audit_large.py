"""The port's meta-device support audit against the reference's committed
support matrix: the five large architectures (their full widths and depths
traced on the ``meta`` device, kernel switches on), split from
``test_torch_audit.py`` to keep each file's time short."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_audit import check_config_against_reference  # noqa: E402  # repro: allow[tier1-deps] — the shared audit check; the large configs split off to keep each file short

LARGE = ["qwen3-moe-30b-a3b", "qwen1.5-32b", "deepseek-67b", "jamba-1.5-large-398b",
         "llama-3.2-vision-90b"]


@pytest.mark.parametrize("name", LARGE)
def test_audit_matches_reference(name):
    check_config_against_reference(name)


def test_the_audit_covers_every_config():
    from test_torch_audit import SMALL  # repro: allow[tier1-deps] — the small configs' list
    from repro_torch.analysis.abstract import ALL_CONFIG_IDS  # repro: allow[tier1-deps] — the port under test

    assert sorted(SMALL + LARGE) == sorted(ALL_CONFIG_IDS) and len(ALL_CONFIG_IDS) == 14
