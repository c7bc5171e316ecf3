"""Entry points of the port's LM stack: step factories (``steps``), the
training driver (``train``) and the greedy decode loop through the serving
engine (``serve``)."""
