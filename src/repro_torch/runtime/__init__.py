"""The fault-tolerant training runtime (port of ``repro.runtime``)."""
