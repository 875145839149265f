from litepi_tpu_torch.pipeline.streaming import StreamingRunner
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline

__all__ = ["StreamingRunner", "TwoStagePipeline"]
