from litepi_tpu_torch.pipeline.evaluator import PipelineEvaluator, write_results
from litepi_tpu_torch.pipeline.streaming import StreamingRunner
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline

__all__ = ["PipelineEvaluator", "StreamingRunner", "TwoStagePipeline", "write_results"]
