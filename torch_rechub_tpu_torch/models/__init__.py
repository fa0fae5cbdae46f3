from . import generative, matching, multi_task, ranking

__all__ = ["ranking", "matching", "multi_task", "generative"]
