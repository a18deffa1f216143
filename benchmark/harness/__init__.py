"""The benchmark harness: lookup of every named piece (`spec`), the
traffic generator (`traffic`), spans around the solver's layers (`spans`),
the padded profiler window and its reading (`trace`), the comparison with
the reference (`check`) and one run of a cell (`cell`)."""
