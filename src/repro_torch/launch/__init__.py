"""Entry points of the port's LM stack: step factories (``steps``), the
training driver (``train``), the greedy decode loop through the serving
engine (``serve``), the roofline arithmetic of a cell (``roofline``) and
the production meshes over ``torch.distributed`` (``mesh``)."""
