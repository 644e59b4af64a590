"""The ATRAC3 device packer: ``device_pack.channel_fields`` (the field
planes) and ``deposit_fields`` (the bit deposit), ms per call, the device
synchronised around each."""
SPANS = [{"name": "at3_pack_fields", "target": "{device_pack}:channel_fields",
          "clock": "sync"},
         {"name": "at3_pack_deposit", "target": "{device_pack}:deposit_fields",
          "clock": "sync"}]


def read(trace):
    return trace.span_ms_per_call("at3_pack_fields", "at3_pack_deposit")
