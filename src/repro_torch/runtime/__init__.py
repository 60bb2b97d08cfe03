from .serve_loop import (CoherenceReport, DecodeReplica,
                         MultiHostServingCluster, Request, ServingCluster)

__all__ = ["CoherenceReport", "DecodeReplica", "MultiHostServingCluster",
           "Request", "ServingCluster"]
