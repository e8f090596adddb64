# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: exhook.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x65xhook.proto\x12\x0e\x65mqx.exhook.v2\"\x0e\n\x0c\x45mptySuccess\"T\n\x0bRequestMeta\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x10\n\x08sysdescr\x18\x03 \x01(\t\x12\x14\n\x0c\x63luster_name\x18\x04 \x01(\t\"Q\n\nBrokerInfo\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08sysdescr\x18\x02 \x01(\t\x12\x0e\n\x06uptime\x18\x03 \x01(\t\x12\x10\n\x08\x64\x61tetime\x18\x04 \x01(\t\"(\n\x08HookSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06topics\x18\x02 \x03(\t\"\xc3\x01\n\nClientInfo\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x10\n\x08\x63lientid\x18\x02 \x01(\t\x12\x10\n\x08username\x18\x03 \x01(\t\x12\x10\n\x08password\x18\x04 \x01(\t\x12\x10\n\x08peerhost\x18\x05 \x01(\t\x12\x10\n\x08sockport\x18\x06 \x01(\r\x12\x10\n\x08protocol\x18\x07 \x01(\t\x12\x12\n\nmountpoint\x18\x08 \x01(\t\x12\x14\n\x0cis_superuser\x18\t \x01(\x08\x12\x11\n\tanonymous\x18\n \x01(\x08\"\x9a\x01\n\x08\x43onnInfo\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\x10\n\x08\x63lientid\x18\x02 \x01(\t\x12\x10\n\x08username\x18\x03 \x01(\t\x12\x10\n\x08peerhost\x18\x04 \x01(\t\x12\x10\n\x08sockport\x18\x05 \x01(\r\x12\x12\n\nproto_name\x18\x06 \x01(\t\x12\x11\n\tproto_ver\x18\x07 \x01(\t\x12\x11\n\tkeepalive\x18\x08 \x01(\r\"\xd8\x01\n\x07Message\x12\x0c\n\x04node\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\x0b\n\x03qos\x18\x03 \x01(\r\x12\x0c\n\x04\x66rom\x18\x04 \x01(\t\x12\r\n\x05topic\x18\x05 \x01(\t\x12\x0f\n\x07payload\x18\x06 \x01(\x0c\x12\x11\n\ttimestamp\x18\x07 \x01(\x04\x12\x35\n\x07headers\x18\x08 \x03(\x0b\x32$.emqx.exhook.v2.Message.HeadersEntry\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\'\n\x08Property\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"(\n\x0bTopicFilter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03qos\x18\x02 \x01(\r\"J\n\x07SubOpts\x12\x0b\n\x03qos\x18\x01 \x01(\r\x12\r\n\x05share\x18\x02 \x01(\t\x12\n\n\x02rh\x18\x03 \x01(\r\x12\x0b\n\x03rap\x18\x04 \x01(\r\x12\n\n\x02nl\x18\x05 \x01(\r\"\xd8\x01\n\x0eValuedResponse\x12:\n\x04type\x18\x01 \x01(\x0e\x32,.emqx.exhook.v2.ValuedResponse.ResponsedType\x12\x15\n\x0b\x62ool_result\x18\x03 \x01(\x08H\x00\x12*\n\x07message\x18\x04 \x01(\x0b\x32\x17.emqx.exhook.v2.MessageH\x00\">\n\rResponsedType\x12\x0c\n\x08\x43ONTINUE\x10\x00\x12\n\n\x06IGNORE\x10\x01\x12\x13\n\x0fSTOP_AND_RETURN\x10\x02\x42\x07\n\x05value\"n\n\x15ProviderLoadedRequest\x12*\n\x06\x62roker\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.BrokerInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"9\n\x0eLoadedResponse\x12\'\n\x05hooks\x18\x01 \x03(\x0b\x32\x18.emqx.exhook.v2.HookSpec\"D\n\x17ProviderUnloadedRequest\x12)\n\x04meta\x18\x01 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x96\x01\n\x14\x43lientConnectRequest\x12*\n\x08\x63onninfo\x18\x01 \x01(\x0b\x32\x18.emqx.exhook.v2.ConnInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v2.Property\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\xab\x01\n\x14\x43lientConnackRequest\x12*\n\x08\x63onninfo\x18\x01 \x01(\x0b\x32\x18.emqx.exhook.v2.ConnInfo\x12\x13\n\x0bresult_code\x18\x02 \x01(\t\x12\'\n\x05props\x18\x03 \x03(\x0b\x32\x18.emqx.exhook.v2.Property\x12)\n\x04meta\x18\x04 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"s\n\x16\x43lientConnectedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x86\x01\n\x19\x43lientDisconnectedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\x0e\n\x06reason\x18\x02 \x01(\t\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x86\x01\n\x19\x43lientAuthenticateRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\x0e\n\x06result\x18\x02 \x01(\x08\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x89\x02\n\x16\x43lientAuthorizeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\x45\n\x04type\x18\x02 \x01(\x0e\x32\x37.emqx.exhook.v2.ClientAuthorizeRequest.AuthorizeReqType\x12\r\n\x05topic\x18\x03 \x01(\t\x12\x0e\n\x06result\x18\x04 \x01(\x08\x12)\n\x04meta\x18\x05 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\".\n\x10\x41uthorizeReqType\x12\x0b\n\x07PUBLISH\x10\x00\x12\r\n\tSUBSCRIBE\x10\x01\"\xd0\x01\n\x16\x43lientSubscribeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v2.Property\x12\x32\n\rtopic_filters\x18\x03 \x03(\x0b\x32\x1b.emqx.exhook.v2.TopicFilter\x12)\n\x04meta\x18\x04 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\xd2\x01\n\x18\x43lientUnsubscribeRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\'\n\x05props\x18\x02 \x03(\x0b\x32\x18.emqx.exhook.v2.Property\x12\x32\n\rtopic_filters\x18\x03 \x03(\x0b\x32\x1b.emqx.exhook.v2.TopicFilter\x12)\n\x04meta\x18\x04 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"r\n\x15SessionCreatedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\xae\x01\n\x18SessionSubscribedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\r\n\x05topic\x18\x02 \x01(\t\x12(\n\x07subopts\x18\x03 \x01(\x0b\x32\x17.emqx.exhook.v2.SubOpts\x12)\n\x04meta\x18\x04 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x86\x01\n\x1aSessionUnsubscribedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\r\n\x05topic\x18\x02 \x01(\t\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"r\n\x15SessionResumedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"t\n\x17SessionDiscardedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"t\n\x17SessionTakenoverRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x85\x01\n\x18SessionTerminatedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12\x0e\n\x06reason\x18\x02 \x01(\t\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"l\n\x15MessagePublishRequest\x12(\n\x07message\x18\x01 \x01(\x0b\x32\x17.emqx.exhook.v2.Message\x12)\n\x04meta\x18\x02 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x9e\x01\n\x17MessageDeliveredRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12(\n\x07message\x18\x02 \x01(\x0b\x32\x17.emqx.exhook.v2.Message\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"|\n\x15MessageDroppedRequest\x12(\n\x07message\x18\x01 \x01(\x0b\x32\x17.emqx.exhook.v2.Message\x12\x0e\n\x06reason\x18\x02 \x01(\t\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"\x9a\x01\n\x13MessageAckedRequest\x12.\n\nclientinfo\x18\x01 \x01(\x0b\x32\x1a.emqx.exhook.v2.ClientInfo\x12(\n\x07message\x18\x02 \x01(\x0b\x32\x17.emqx.exhook.v2.Message\x12)\n\x04meta\x18\x03 \x01(\x0b\x32\x1b.emqx.exhook.v2.RequestMeta\"P\n\rSnapshotChunk\x12\r\n\x05\x65poch\x18\x01 \x01(\x04\x12\x0f\n\x07\x66ilters\x18\x02 \x03(\t\x12\x11\n\trefcounts\x18\x03 \x03(\r\x12\x0c\n\x04last\x18\x04 \x01(\x08\"\xc6\x01\n\nDeltaBatch\x12\x12\n\nfrom_epoch\x18\x01 \x01(\x04\x12\x10\n\x08to_epoch\x18\x02 \x01(\x04\x12\x30\n\x06\x64\x65ltas\x18\x03 \x03(\x0b\x32 .emqx.exhook.v2.DeltaBatch.Delta\x1a`\n\x05\x44\x65lta\x12/\n\x02op\x18\x01 \x01(\x0e\x32#.emqx.exhook.v2.DeltaBatch.Delta.Op\x12\x0e\n\x06\x66ilter\x18\x02 \x01(\t\"\x16\n\x02Op\x12\x07\n\x03\x41\x44\x44\x10\x00\x12\x07\n\x03\x44\x45L\x10\x01\"@\n\x0bSnapshotAck\x12\r\n\x05\x65poch\x18\x01 \x01(\x04\x12\x11\n\tn_filters\x18\x02 \x01(\r\x12\x0f\n\x07rebuilt\x18\x03 \x01(\x08\"#\n\x11MatchBatchRequest\x12\x0e\n\x06topics\x18\x01 \x03(\t\"\x96\x01\n\x12MatchBatchResponse\x12;\n\x07results\x18\x01 \x03(\x0b\x32*.emqx.exhook.v2.MatchBatchResponse.Matches\x12\r\n\x05\x65poch\x18\x02 \x01(\x04\x12\x15\n\rtable_version\x18\x03 \x01(\x04\x1a\x1d\n\x07Matches\x12\x12\n\nfilter_ids\x18\x01 \x03(\r\"\x14\n\x12\x46ilterTableRequest\"=\n\x13\x46ilterTableResponse\x12\x15\n\rtable_version\x18\x01 \x01(\x04\x12\x0f\n\x07\x66ilters\x18\x02 \x03(\t\"\x0e\n\x0cStatsRequest\"\x97\x02\n\rStatsResponse\x12\r\n\x05\x65poch\x18\x01 \x01(\x04\x12\x11\n\tn_filters\x18\x02 \x01(\r\x12\x10\n\x08n_states\x18\x03 \x01(\r\x12\x0f\n\x07\x62\x61tches\x18\x04 \x01(\x04\x12\x16\n\x0etopics_matched\x18\x05 \x01(\x04\x12\x14\n\x0cp50_batch_ms\x18\x06 \x01(\x01\x12\x14\n\x0cp99_batch_ms\x18\x07 \x01(\x01\x12\x16\n\x0epending_deltas\x18\x08 \x01(\r\x12\x37\n\x05\x65xtra\x18\t \x03(\x0b\x32(.emqx.exhook.v2.StatsResponse.ExtraEntry\x1a,\n\nExtraEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\x9d\x0f\n\x0cHookProvider\x12Y\n\x10OnProviderLoaded\x12%.emqx.exhook.v2.ProviderLoadedRequest\x1a\x1e.emqx.exhook.v2.LoadedResponse\x12[\n\x12OnProviderUnloaded\x12\'.emqx.exhook.v2.ProviderUnloadedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12U\n\x0fOnClientConnect\x12$.emqx.exhook.v2.ClientConnectRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12U\n\x0fOnClientConnack\x12$.emqx.exhook.v2.ClientConnackRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12Y\n\x11OnClientConnected\x12&.emqx.exhook.v2.ClientConnectedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12_\n\x14OnClientDisconnected\x12).emqx.exhook.v2.ClientDisconnectedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12\x61\n\x14OnClientAuthenticate\x12).emqx.exhook.v2.ClientAuthenticateRequest\x1a\x1e.emqx.exhook.v2.ValuedResponse\x12[\n\x11OnClientAuthorize\x12&.emqx.exhook.v2.ClientAuthorizeRequest\x1a\x1e.emqx.exhook.v2.ValuedResponse\x12Y\n\x11OnClientSubscribe\x12&.emqx.exhook.v2.ClientSubscribeRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12]\n\x13OnClientUnsubscribe\x12(.emqx.exhook.v2.ClientUnsubscribeRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12W\n\x10OnSessionCreated\x12%.emqx.exhook.v2.SessionCreatedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12]\n\x13OnSessionSubscribed\x12(.emqx.exhook.v2.SessionSubscribedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12\x61\n\x15OnSessionUnsubscribed\x12*.emqx.exhook.v2.SessionUnsubscribedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12W\n\x10OnSessionResumed\x12%.emqx.exhook.v2.SessionResumedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12[\n\x12OnSessionDiscarded\x12\'.emqx.exhook.v2.SessionDiscardedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12[\n\x12OnSessionTakenover\x12\'.emqx.exhook.v2.SessionTakenoverRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12]\n\x13OnSessionTerminated\x12(.emqx.exhook.v2.SessionTerminatedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12Y\n\x10OnMessagePublish\x12%.emqx.exhook.v2.MessagePublishRequest\x1a\x1e.emqx.exhook.v2.ValuedResponse\x12[\n\x12OnMessageDelivered\x12\'.emqx.exhook.v2.MessageDeliveredRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12W\n\x10OnMessageDropped\x12%.emqx.exhook.v2.MessageDroppedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess\x12S\n\x0eOnMessageAcked\x12#.emqx.exhook.v2.MessageAckedRequest\x1a\x1c.emqx.exhook.v2.EmptySuccess2\x98\x03\n\nMirrorSync\x12O\n\x0fInstallSnapshot\x12\x1d.emqx.exhook.v2.SnapshotChunk\x1a\x1b.emqx.exhook.v2.SnapshotAck(\x01\x12\x46\n\x0b\x41pplyDeltas\x12\x1a.emqx.exhook.v2.DeltaBatch\x1a\x1b.emqx.exhook.v2.SnapshotAck\x12S\n\nMatchBatch\x12!.emqx.exhook.v2.MatchBatchRequest\x1a\".emqx.exhook.v2.MatchBatchResponse\x12V\n\x0b\x46ilterTable\x12\".emqx.exhook.v2.FilterTableRequest\x1a#.emqx.exhook.v2.FilterTableResponse\x12\x44\n\x05Stats\x12\x1c.emqx.exhook.v2.StatsRequest\x1a\x1d.emqx.exhook.v2.StatsResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'exhook_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MESSAGE_HEADERSENTRY._options = None
  _MESSAGE_HEADERSENTRY._serialized_options = b'8\001'
  _STATSRESPONSE_EXTRAENTRY._options = None
  _STATSRESPONSE_EXTRAENTRY._serialized_options = b'8\001'
  _EMPTYSUCCESS._serialized_start=32
  _EMPTYSUCCESS._serialized_end=46
  _REQUESTMETA._serialized_start=48
  _REQUESTMETA._serialized_end=132
  _BROKERINFO._serialized_start=134
  _BROKERINFO._serialized_end=215
  _HOOKSPEC._serialized_start=217
  _HOOKSPEC._serialized_end=257
  _CLIENTINFO._serialized_start=260
  _CLIENTINFO._serialized_end=455
  _CONNINFO._serialized_start=458
  _CONNINFO._serialized_end=612
  _MESSAGE._serialized_start=615
  _MESSAGE._serialized_end=831
  _MESSAGE_HEADERSENTRY._serialized_start=785
  _MESSAGE_HEADERSENTRY._serialized_end=831
  _PROPERTY._serialized_start=833
  _PROPERTY._serialized_end=872
  _TOPICFILTER._serialized_start=874
  _TOPICFILTER._serialized_end=914
  _SUBOPTS._serialized_start=916
  _SUBOPTS._serialized_end=990
  _VALUEDRESPONSE._serialized_start=993
  _VALUEDRESPONSE._serialized_end=1209
  _VALUEDRESPONSE_RESPONSEDTYPE._serialized_start=1138
  _VALUEDRESPONSE_RESPONSEDTYPE._serialized_end=1200
  _PROVIDERLOADEDREQUEST._serialized_start=1211
  _PROVIDERLOADEDREQUEST._serialized_end=1321
  _LOADEDRESPONSE._serialized_start=1323
  _LOADEDRESPONSE._serialized_end=1380
  _PROVIDERUNLOADEDREQUEST._serialized_start=1382
  _PROVIDERUNLOADEDREQUEST._serialized_end=1450
  _CLIENTCONNECTREQUEST._serialized_start=1453
  _CLIENTCONNECTREQUEST._serialized_end=1603
  _CLIENTCONNACKREQUEST._serialized_start=1606
  _CLIENTCONNACKREQUEST._serialized_end=1777
  _CLIENTCONNECTEDREQUEST._serialized_start=1779
  _CLIENTCONNECTEDREQUEST._serialized_end=1894
  _CLIENTDISCONNECTEDREQUEST._serialized_start=1897
  _CLIENTDISCONNECTEDREQUEST._serialized_end=2031
  _CLIENTAUTHENTICATEREQUEST._serialized_start=2034
  _CLIENTAUTHENTICATEREQUEST._serialized_end=2168
  _CLIENTAUTHORIZEREQUEST._serialized_start=2171
  _CLIENTAUTHORIZEREQUEST._serialized_end=2436
  _CLIENTAUTHORIZEREQUEST_AUTHORIZEREQTYPE._serialized_start=2390
  _CLIENTAUTHORIZEREQUEST_AUTHORIZEREQTYPE._serialized_end=2436
  _CLIENTSUBSCRIBEREQUEST._serialized_start=2439
  _CLIENTSUBSCRIBEREQUEST._serialized_end=2647
  _CLIENTUNSUBSCRIBEREQUEST._serialized_start=2650
  _CLIENTUNSUBSCRIBEREQUEST._serialized_end=2860
  _SESSIONCREATEDREQUEST._serialized_start=2862
  _SESSIONCREATEDREQUEST._serialized_end=2976
  _SESSIONSUBSCRIBEDREQUEST._serialized_start=2979
  _SESSIONSUBSCRIBEDREQUEST._serialized_end=3153
  _SESSIONUNSUBSCRIBEDREQUEST._serialized_start=3156
  _SESSIONUNSUBSCRIBEDREQUEST._serialized_end=3290
  _SESSIONRESUMEDREQUEST._serialized_start=3292
  _SESSIONRESUMEDREQUEST._serialized_end=3406
  _SESSIONDISCARDEDREQUEST._serialized_start=3408
  _SESSIONDISCARDEDREQUEST._serialized_end=3524
  _SESSIONTAKENOVERREQUEST._serialized_start=3526
  _SESSIONTAKENOVERREQUEST._serialized_end=3642
  _SESSIONTERMINATEDREQUEST._serialized_start=3645
  _SESSIONTERMINATEDREQUEST._serialized_end=3778
  _MESSAGEPUBLISHREQUEST._serialized_start=3780
  _MESSAGEPUBLISHREQUEST._serialized_end=3888
  _MESSAGEDELIVEREDREQUEST._serialized_start=3891
  _MESSAGEDELIVEREDREQUEST._serialized_end=4049
  _MESSAGEDROPPEDREQUEST._serialized_start=4051
  _MESSAGEDROPPEDREQUEST._serialized_end=4175
  _MESSAGEACKEDREQUEST._serialized_start=4178
  _MESSAGEACKEDREQUEST._serialized_end=4332
  _SNAPSHOTCHUNK._serialized_start=4334
  _SNAPSHOTCHUNK._serialized_end=4414
  _DELTABATCH._serialized_start=4417
  _DELTABATCH._serialized_end=4615
  _DELTABATCH_DELTA._serialized_start=4519
  _DELTABATCH_DELTA._serialized_end=4615
  _DELTABATCH_DELTA_OP._serialized_start=4593
  _DELTABATCH_DELTA_OP._serialized_end=4615
  _SNAPSHOTACK._serialized_start=4617
  _SNAPSHOTACK._serialized_end=4681
  _MATCHBATCHREQUEST._serialized_start=4683
  _MATCHBATCHREQUEST._serialized_end=4718
  _MATCHBATCHRESPONSE._serialized_start=4721
  _MATCHBATCHRESPONSE._serialized_end=4871
  _MATCHBATCHRESPONSE_MATCHES._serialized_start=4842
  _MATCHBATCHRESPONSE_MATCHES._serialized_end=4871
  _FILTERTABLEREQUEST._serialized_start=4873
  _FILTERTABLEREQUEST._serialized_end=4893
  _FILTERTABLERESPONSE._serialized_start=4895
  _FILTERTABLERESPONSE._serialized_end=4956
  _STATSREQUEST._serialized_start=4958
  _STATSREQUEST._serialized_end=4972
  _STATSRESPONSE._serialized_start=4975
  _STATSRESPONSE._serialized_end=5254
  _STATSRESPONSE_EXTRAENTRY._serialized_start=5210
  _STATSRESPONSE_EXTRAENTRY._serialized_end=5254
  _HOOKPROVIDER._serialized_start=5257
  _HOOKPROVIDER._serialized_end=7206
  _MIRRORSYNC._serialized_start=7209
  _MIRRORSYNC._serialized_end=7617
# @@protoc_insertion_point(module_scope)
