"""The device engine: state, round loop, packet pump and its kernel,
and the ensemble plane."""
