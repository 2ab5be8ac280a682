from univtg_tpu_torch.models.config import ModelConfig  # noqa: F401
from univtg_tpu_torch.models.univtg import UniVTG  # noqa: F401
