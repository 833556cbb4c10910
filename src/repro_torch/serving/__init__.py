"""Serving of the port: model replicas on the GPU (:mod:`.engine`), the
scale-per-request platform (:mod:`.platform`) and the simulator-driven
keep-alive planner (:mod:`.autoscale`)."""
