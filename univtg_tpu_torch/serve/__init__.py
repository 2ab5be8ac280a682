from univtg_tpu_torch.serve.pipeline import GroundingPipeline, PreparedVideo  # noqa: F401
from univtg_tpu_torch.serve.server import GroundingServer, MicroBatcher, VideoStore  # noqa: F401
