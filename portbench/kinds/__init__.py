"""One module a kind of traffic (its runner and its plan), found by the traffic file's
``kind``."""
