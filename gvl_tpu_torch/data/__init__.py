"""The port's data layer: copies of gvl_tpu/data (vocabulary, features,
dataset and batcher, the synthetic dataset)."""

from gvl_tpu_torch.data.vocabulary import Translator, ClassMap  # noqa: F401
from gvl_tpu_torch.data.dataset import DenseVideoDataset, Batcher  # noqa: F401
