"""The device engine: state, round loop, packet pump and its kernel."""
