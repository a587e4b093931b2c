"""The remote data plane: a coordinator leasing shards over TCP to worker
processes (:mod:`.coordinator`, :mod:`.worker`, :mod:`.transport`).

Counterpart of the ``repro/distributed`` namespace package. It imports
nothing here: a worker's import closure stays torch-free under a host
backend (the contract lint's rule R001).
"""
