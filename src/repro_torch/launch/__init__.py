"""Entry points of the port's LM stack: step factories (``steps``), the
training driver (``train``), the greedy decode loop through the serving
engine (``serve``), the roofline arithmetic of a cell (``roofline``) and
the production meshes over ``torch.distributed``, their axis groups and an
in-process emulation of a mesh (``mesh``), and the logical placement of
every parameter, batch and cache leaf over a mesh (``sharding``)."""
