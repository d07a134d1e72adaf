"""Job protocols of the traffic mixes, one file each: traffic/<mix>.json
names its protocol, protocols/<protocol>.py runs it."""
