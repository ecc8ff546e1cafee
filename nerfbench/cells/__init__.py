"""The harness's kinds of traffic, one module each, chosen by a traffic
file's ``kind``."""
