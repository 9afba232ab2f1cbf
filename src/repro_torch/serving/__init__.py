from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.topics import TopicRequest, TopicServer

__all__ = ["Request", "ServingEngine", "TopicRequest", "TopicServer"]
