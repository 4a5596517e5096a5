"""Transport stacks: header lane packing and the TCP flow table."""
