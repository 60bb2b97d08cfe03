from .serve_loop import (CoherenceReport, DecodeReplica,
                         MultiHostServingCluster, Request, ServingCluster)
from .train_loop import TrainConfig, build_step, train
from .elastic import ElasticReport, ElasticTrainer

__all__ = ["CoherenceReport", "DecodeReplica", "MultiHostServingCluster",
           "Request", "ServingCluster", "TrainConfig", "build_step", "train",
           "ElasticReport", "ElasticTrainer"]
