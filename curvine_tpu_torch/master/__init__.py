"""The port's cache master: namespace, block map, workers and journal."""
