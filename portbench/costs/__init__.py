"""The yardstick's arithmetic: operations of a forward, bytes of a kernel
launch, and the card's published peaks."""
