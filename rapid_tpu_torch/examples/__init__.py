"""The port's examples: the paper's load balancer on live membership
(``python -m rapid_tpu_torch.examples.load_balancer``), a real member in a
swarm on the card (``python -m rapid_tpu_torch.examples.swarm_agent``) and
an agent on an injected transport (``python -m
rapid_tpu_torch.examples.agent_with_custom_messaging``). The swarm runs on
the CUDA device unless ``--device cpu`` is given."""
