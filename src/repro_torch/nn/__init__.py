"""Functional NN building blocks of the port's LM: layers and attention."""
