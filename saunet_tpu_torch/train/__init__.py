from .state import InferState, make_infer_step

__all__ = ["InferState", "make_infer_step"]
