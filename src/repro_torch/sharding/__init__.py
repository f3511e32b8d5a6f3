"""Tensor-parallel placement: the logical-axis rules, the ambient
sharding context and the port's only route to a collective."""
