"""Serving entry points of the port: step factories (``steps``) and the
greedy decode loop through the serving engine (``serve``)."""
