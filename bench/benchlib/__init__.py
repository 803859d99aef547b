"""The benchmark harness of the port: cells, generator, runner, check."""
