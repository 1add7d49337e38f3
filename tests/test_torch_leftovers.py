"""Small pieces of ported modules against ``ddw_tpu``: the model registry's
``register_model`` / ``MODEL_REGISTRY``, ``TransformerLM.frozen_prefixes``,
``TableStore.list_tables`` and ``DataCfg.image_shape``."""

import pytest
import torch

from ddw_tpu.data.store import TableStore as JaxTableStore
from ddw_tpu.models import registry as jax_registry
from ddw_tpu.models.lm import TransformerLM as JaxTransformerLM
from ddw_tpu.utils.config import DataCfg as JaxDataCfg
from ddw_tpu_torch.data.store import Record, TableStore
from ddw_tpu_torch.models import registry
from ddw_tpu_torch.models.lm import TransformerLM
from ddw_tpu_torch.utils.config import DataCfg, ModelCfg


def test_registry_names_and_register_model():
    assert set(registry.MODEL_REGISTRY) == set(jax_registry.MODEL_REGISTRY)

    @registry.register_model("tiny_linear")
    def tiny(cfg, image_size):
        return torch.nn.Linear(image_size[0], cfg.num_classes)

    try:
        assert registry.MODEL_REGISTRY["tiny_linear"] is tiny
        m = registry.build_model(ModelCfg(name="tiny_linear", num_classes=3,
                                          freeze_base=False), (4, 4))
        assert isinstance(m, torch.nn.Linear) and m.out_features == 3
    finally:
        del registry.MODEL_REGISTRY["tiny_linear"]
    with pytest.raises(KeyError, match="unknown model"):
        registry.build_model(ModelCfg(name="tiny_linear"))


@pytest.mark.parametrize("freeze", [True, False])
def test_lm_frozen_prefixes(freeze):
    assert TransformerLM.frozen_prefixes(freeze) == \
        JaxTransformerLM.frozen_prefixes(freeze) == ()


def test_list_tables(tmp_path):
    for root, store_cls in ((tmp_path / "t", TableStore),
                            (tmp_path / "j", JaxTableStore)):
        store = store_cls(str(root))
        assert store.list_tables() == []
        for name in ("zeta", "alpha"):
            store.write(name, [Record("p", b"x", "c", 0)])
        (root / "stray.txt").write_text("not a table")
    assert TableStore(str(tmp_path / "t")).list_tables() == \
        JaxTableStore(str(tmp_path / "j")).list_tables() == ["alpha", "zeta"]
    assert TableStore(str(tmp_path / "gone")).list_tables() == []


@pytest.mark.parametrize("kw", [{}, dict(img_height=32, img_width=48,
                                         channels=1)])
def test_data_cfg_image_shape(kw):
    assert DataCfg(**kw).image_shape == JaxDataCfg(**kw).image_shape
