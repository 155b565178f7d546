"""The benchmark's harness: cell lookup, traffic, loops, trace reading and
the check of what the timed path produced."""
