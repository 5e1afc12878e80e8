"""``test_sharded_step_matches_single`` on (2, 2) CPU slots: every reduced
config's sharded train step against the unsharded port's (the body and its
bounds in ``torch_sharded_train_common``). The cases of each mesh live in a
file of their own so that ``pytest --dist loadfile`` runs the three meshes
on three workers."""
import pytest

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from torch_sharded_train_common import step_matches_single  # noqa: E402

ARCHS = jconfigs.list_archs()


@pytest.mark.parametrize("mesh", ["2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_single(arch, mesh):
    """Every reduced config over (2, 2) slots: the loss and every gathered
    gradient against the unsharded port's, then two AdamW steps against
    ``build_step``'s, the parameters gathered."""
    step_matches_single(arch, mesh)
