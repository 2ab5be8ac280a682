from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig  # noqa: F401
from univtg_tpu_torch.extract.clip.tokenizer import tokenize  # noqa: F401
