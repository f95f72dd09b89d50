from cora_tpu_torch.graph.problem import Problem  # noqa: F401
