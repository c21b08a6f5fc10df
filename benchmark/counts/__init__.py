"""The yardstick's arithmetic: the card's peaks, each kernel's operations
and bytes, and each model's matrix-product operations. They count the
algorithm's work for the inputs the harness sent, whatever implements it,
so a later kernel that does the same work is read by the same yardstick."""
